"""The port's mesh and collectives (velociraptor_stf_tpu_torch/parallel/
mesh.py, collectives.py) and the whole-groups deal (grouppack.py) on a
mesh of CPU shards: the ring ppermute, reductions in fixed shard order,
the audit counters, the serpentine LPT deal against the JAX package's
function, and the pack / unpack round trip of the group blocks.  All
exact.
"""

import numpy as np
import pytest
import torch

from velociraptor_stf_tpu.parallel.grouppack import \
    assign_groups_lpt as jax_lpt

from velociraptor_stf_tpu_torch.parallel import collectives as col
from velociraptor_stf_tpu_torch.parallel.grouppack import (
    assign_groups_lpt, plan_group_blocks)
from velociraptor_stf_tpu_torch.parallel.mesh import Mesh, make_mesh
from velociraptor_stf_tpu_torch.utils import telemetry
from torch_threads import one_torch_thread  # noqa: F401


def test_make_mesh_cpu_shards():
    mesh = make_mesh(8, "cpu")
    assert mesh.size == 8 and mesh.home == torch.device("cpu")
    assert all(d.type == "cpu" for d in mesh.devices)
    assert make_mesh(device="cpu").size == 1
    assert Mesh(("cpu", "cpu")).devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        Mesh(())


@pytest.mark.parametrize("step", [1, -1, 3])
def test_ring_ppermute(step):
    mesh = make_mesh(8, "cpu")
    xs = [torch.full((5,), float(s)) for s in range(8)]
    out = col.ppermute(mesh, xs, col.ring(mesh, step))
    for d in range(8):
        assert torch.equal(out[d], xs[(d - step) % 8])


def test_ppermute_unreached_shards_get_zeros():
    mesh = make_mesh(4, "cpu")
    xs = [torch.full((3,), s + 1.0) for s in range(4)]
    out = col.ppermute(mesh, xs, [(0, 1)])
    assert torch.equal(out[1], xs[0])
    for d in (0, 2, 3):
        assert torch.equal(out[d], torch.zeros(3))


def test_psum_adds_in_shard_order():
    """float32 sums that depend on the order: the result is the sum
    0 + 1 + ... + 7 in that order, on every shard, and min / max and the
    gather agree with numpy."""
    mesh = make_mesh(8, "cpu")
    vals = np.array([1e8, 1.0, -1e8, 3.0, 0.5, 1e-3, 7e7, -7e7], np.float32)
    xs = [torch.tensor([v]) for v in vals]
    acc = np.float32(0)
    for v in vals:
        acc = np.float32(acc + v)
    want = np.float32(vals[0])
    for v in vals[1:]:
        want = np.float32(want + v)
    out = col.psum(mesh, xs)
    assert len(out) == 8
    assert all(float(o[0]) == float(want) for o in out)
    assert float(col.pmax(mesh, xs)[3][0]) == vals.max()
    assert float(col.pmin(mesh, xs)[5][0]) == vals.min()
    gathered = col.all_gather(mesh, xs)[2]
    np.testing.assert_array_equal(gathered.numpy()[:, 0], vals)


def test_results_do_not_depend_on_shard_placement():
    """A payload dealt to the shards in any order gives the same reduced
    tables: segment sums per shard, psum in shard order, integer exact
    and float within the float64 rounding of the partials."""
    rng = np.random.default_rng(3)
    n, ng1 = 4000, 17
    g = torch.from_numpy(rng.integers(0, ng1, n))
    w = torch.from_numpy(rng.uniform(0, 2, n))
    mesh = make_mesh(8, "cpu")

    def reduced(perm):
        parts = np.array_split(perm, 8)
        cnt = col.psum(mesh, [torch.bincount(g[p], minlength=ng1)
                              for p in parts])[0]
        tot = col.psum(mesh, [torch.zeros(ng1, dtype=torch.float64)
                              .index_add_(0, g[p], w[p]) for p in parts])[0]
        return cnt, tot

    c0, t0 = reduced(np.arange(n))
    c1, t1 = reduced(rng.permutation(n))
    assert torch.equal(c0, c1)
    assert torch.equal(c0, torch.bincount(g, minlength=ng1))
    np.testing.assert_allclose(t1.numpy(), t0.numpy(), rtol=1e-13)


def test_audit_counters():
    """Payload bytes and op counts by stage and kind; nothing counted
    outside a stage."""
    mesh = make_mesh(4, "cpu")
    xs = [torch.zeros(10 + s, dtype=torch.float32) for s in range(4)]
    telemetry.reset()
    col.ppermute(mesh, xs, col.ring(mesh, 1))
    assert not telemetry.snapshot()
    with col.audit_stage("outer"):
        with col.audit_stage("inner"):
            col.ppermute(mesh, xs, col.ring(mesh, 1))
        col.psum(mesh, [torch.zeros(6, dtype=torch.int64)] * 4)
        col.ppermute(mesh, xs, col.ring(mesh, -1))
    col.count_reshard("deal", xs)
    snap = telemetry.snapshot()
    assert snap["coll_bytes::inner::ppermute"] == 13 * 4
    assert snap["coll_ops::inner::ppermute"] == 1
    assert snap["coll_bytes::outer::psum"] == 48
    assert snap["coll_ops::outer::ppermute"] == 1
    assert snap["coll_bytes::deal::reshard"] == (10 + 11 + 12 + 13) * 4

    @col.staged("deco")
    def stage():
        col.pmax(mesh, [torch.zeros(2)] * 4)

    stage()
    assert telemetry.snapshot()["coll_ops::deco::pmax"] == 1


@pytest.mark.parametrize("ndev", [2, 3, 8])
def test_assign_groups_lpt_matches_reference(ndev):
    rng = np.random.default_rng(ndev)
    sizes = np.concatenate([[0], rng.integers(1, 5000, 999)])
    sizes[5:40] = 77                       # ties keep their id order
    got = assign_groups_lpt(sizes, ndev)
    np.testing.assert_array_equal(got, jax_lpt(sizes, ndev))
    load = np.bincount(got[1:], weights=sizes[1:], minlength=ndev)
    assert load.max() < sizes[1:].sum() / ndev + sizes.max()


@pytest.mark.parametrize("ndev", [1, 3, 8])
def test_group_blocks_pack_unpack_round_trip(ndev):
    rng = np.random.default_rng(10 + ndev)
    n, ng = 5000, 40
    pfof = torch.from_numpy(rng.integers(0, ng + 1, n))
    pfof[pfof == 7] = 0                    # an empty group
    mesh = make_mesh(ndev, "cpu")
    plan = plan_group_blocks(pfof, ng, mesh)
    sizes = torch.bincount(pfof, minlength=ng + 1).numpy()
    sizes[0] = 0
    np.testing.assert_array_equal(plan.dev_of, assign_groups_lpt(sizes,
                                                                 ndev))
    idx = torch.arange(n)
    blocks = plan.pack(idx)
    lgid = plan.pack_local_gids(pfof)
    gids = plan.gids
    for s in range(ndev):
        b, g = blocks[s], lgid[s]
        glob = torch.from_numpy(gids[s])[g]
        # whole groups of this shard, in (global id, original index) order
        assert torch.equal(glob, pfof[b])
        assert (torch.from_numpy(plan.dev_of)[glob] == s).all()
        key = glob * n + b
        assert torch.equal(key, torch.sort(key).values)
        assert int(g.max()) == plan.ng_loc[s] == len(gids[s]) - 1
        assert torch.equal(torch.unique(g), torch.arange(1, plan.ng_loc[s]
                                                         + 1))
    assert sum(b.shape[0] for b in blocks) == int((pfof > 0).sum())
    x = torch.from_numpy(rng.normal(size=(n, 3)))
    back = plan.unpack(plan.pack(x), fill=-1.0)
    tagged = pfof > 0
    assert torch.equal(back[tagged], x[tagged])
    assert (back[~tagged] == -1.0).all()


def test_group_blocks_none_tagged():
    mesh = make_mesh(4, "cpu")
    assert plan_group_blocks(torch.zeros(100, dtype=torch.int64), 3,
                             mesh) is None
