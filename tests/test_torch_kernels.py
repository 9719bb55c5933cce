"""The port's kernel wrappers (velociraptor_stf_tpu_torch/kernels) on small
inputs: argument checks, the plain versions against brute force, and --
on a GPU -- each CUDA kernel against its plain version.

This file imports no jax, so the GPU tests run on a machine without it:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

(``--noconftest``: tests/conftest.py imports jax.)  Without a CUDA device
the ``gpu`` tests skip.
"""

import numpy as np
import pytest
import torch

from velociraptor_stf_tpu_torch.kernels import R_BLOCK
from velociraptor_stf_tpu_torch.kernels import fof_sweep as KF
from velociraptor_stf_tpu_torch.kernels import potential as KP
from velociraptor_stf_tpu_torch.ops import fof_sweep as TF
from velociraptor_stf_tpu_torch.ops import gravity_direct
from velociraptor_stf_tpu_torch.ops import segments as seg


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cloud(seed=0, n=3000, box=10.0):
    """Clumped points in a non-periodic box, cell-sorted with windows for
    linking length 0.15."""
    rng = np.random.default_rng(seed)
    pos = np.vstack([rng.normal(3.0, 0.2, (n // 2, 3)),
                     rng.uniform(0, box, (n - n // 2, 3))]).astype(np.float32)
    ll = 0.15
    ctx, _ = TF.build_fof_ctx(torch.from_numpy(pos), None, ll)
    return ctx, ll


def _brute_d2(p):
    d = p[:, None, :] - p[None, :, :]
    d2 = d[..., 0] * d[..., 0]
    d2 = d2 + d[..., 1] * d[..., 1]
    return d2 + d[..., 2] * d[..., 2]


def test_plain_fof_versions_match_brute_force():
    ctx, ll = _cloud()
    p = ctx.pos.T
    b2 = KF.f32(ll * ll)
    link = _brute_d2(p) <= b2
    cnt = KF.detect_ref(ctx.pos, ctx.windows, b2)
    assert torch.equal(cnt, link.sum(1, dtype=torch.int32))
    lab = torch.randperm(ctx.ns, generator=torch.Generator().manual_seed(1)
                         ).int()
    want = torch.where(link, lab[None, :], KF.BIG_I32).amin(1).int()
    assert torch.equal(KF.sweep3d_ref(ctx.pos, lab, ctx.windows, b2), want)
    # 6D: same nonzero group, phase criterion with per-row scales
    rng = np.random.default_rng(2)
    vel = torch.from_numpy(rng.normal(0, 1, (3, ctx.ns)).astype(np.float32))
    grp = torch.from_numpy(rng.integers(0, 3, ctx.ns).astype(np.int32))
    rivs = torch.from_numpy(rng.uniform(0.5, 2, ctx.ns).astype(np.float32))
    inv_b2 = KF.f32(1.0 / (ll * ll))
    phase = _brute_d2(p) * inv_b2 + _brute_d2(vel.T) * rivs[:, None]
    ok = (phase <= 1.0) & (grp[:, None] == grp[None, :]) & (grp[:, None] > 0)
    want6 = torch.minimum(lab, torch.where(ok, lab[None, :],
                                           KF.BIG_I32).amin(1).int())
    got6 = KF.sweep6d_ref(ctx.pos, vel, rivs, grp, lab, ctx.windows, inv_b2)
    assert torch.equal(got6, want6)


def _grouped(seed=3):
    """Group-sorted particles: a gid-0 run first, groups of assorted sizes,
    the largest group at the array tail."""
    rng = np.random.default_rng(seed)
    sizes = [700, 1, 40, 300, 2, 900]
    g = np.concatenate([np.zeros(500, np.int64)] +
                       [np.full(s, i + 1) for i, s in enumerate(sizes)])
    pos = rng.normal(0, 1, (len(g), 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2, len(g)).astype(np.float32)
    return torch.from_numpy(pos), torch.from_numpy(mass), torch.from_numpy(g)


def test_plain_potential_matches_brute_force():
    pos, mass, g = _grouped()
    offsets = seg.group_offsets(g, int(g.max()))
    win = gravity_direct.block_window(g, offsets)
    assert int(win[0, 0, 1]) == 0             # a gid-0 block: no window
    eps2 = KP.f32(1e-4)
    got = KP.potential_ref(pos.T.contiguous(), mass, g.int(), win, eps2)
    p = pos.double()
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1) + eps2
    same = (g[:, None] == g[None, :]) & (g[:, None] > 0)
    same.fill_diagonal_(False)
    want = torch.where(same, mass.double()[None, :] / d2.sqrt(), 0.0).sum(1)
    assert torch.equal(got[g == 0], torch.zeros(int((g == 0).sum())))
    nz = want != 0
    assert float(((got.double() - want)[nz] / want[nz]).abs().max()) < 1e-5


def test_wrappers_reject_bad_arguments():
    ctx, ll = _cloud(n=600)
    lab = torch.arange(ctx.ns, dtype=torch.int32)
    with pytest.raises(TypeError):
        KF.detect(ctx.pos.double(), ctx.windows, ll * ll)
    with pytest.raises(ValueError):
        KF.detect(ctx.pos.T, ctx.windows, ll * ll)
    with pytest.raises(ValueError):
        KF.detect(ctx.pos, ctx.windows[:-1], ll * ll)
    with pytest.raises(TypeError):
        KF.sweep3d(ctx.pos, lab.long(), ctx.windows, ll * ll)
    with pytest.raises(ValueError):
        KF.sweep3d(ctx.pos, lab[::2], ctx.windows, ll * ll)
    pos, mass, g = _grouped()
    win = gravity_direct.block_window(g, seg.group_offsets(g, int(g.max())))
    with pytest.raises(TypeError):
        KP.potential(pos.T.contiguous(), mass, g, win, 0.0)
    with pytest.raises(ValueError):
        KP.potential(pos.T, mass, g.int(), win, 0.0)   # not contiguous


@pytest.mark.gpu
def test_cuda_fof_kernels_match_plain(cuda):
    ctx, ll = _cloud(n=20000)
    b2 = KF.f32(ll * ll)
    pos = ctx.pos.to(cuda)
    win = ctx.windows.clone()
    win[1] = 0                                # a block with no windows
    win = win.to(cuda)
    cnt = KF.detect(pos, win, b2)
    assert torch.equal(cnt, KF.detect_ref(pos, win, b2))
    assert int(cnt[R_BLOCK:2 * R_BLOCK].sum()) == 0
    lab = torch.randperm(ctx.ns, device=cuda).int()
    got = KF.sweep3d(pos, lab, win, b2)
    assert torch.equal(got, KF.sweep3d_ref(pos, lab, win, b2))
    assert torch.equal(got[R_BLOCK:2 * R_BLOCK], lab[R_BLOCK:2 * R_BLOCK])
    gen = torch.Generator(device=cuda).manual_seed(4)
    vel = torch.randn(3, ctx.ns, device=cuda, generator=gen)
    grp = torch.randint(0, 4, (ctx.ns,), device=cuda, generator=gen,
                        dtype=torch.int32)
    rivs = torch.rand(ctx.ns, device=cuda, generator=gen) + 0.5
    inv_b2 = KF.f32(1.0 / (ll * ll))
    got6 = KF.sweep6d(pos, vel, rivs, grp, lab, win, inv_b2)
    assert torch.equal(got6, KF.sweep6d_ref(pos, vel, rivs, grp, lab, win,
                                            inv_b2))
    assert not torch.equal(got6, lab)


@pytest.mark.gpu
def test_cuda_potential_matches_plain(cuda):
    pos, mass, g = _grouped()
    offsets = seg.group_offsets(g, int(g.max()))
    args = (pos.T.contiguous().to(cuda), mass.to(cuda), g.int().to(cuda),
            gravity_direct.block_window(g, offsets).to(cuda))
    for eps2 in (0.0, 1e-4):
        got = KP.potential(*args, KP.f32(eps2)).double()
        want = KP.potential_ref(*args, KP.f32(eps2)).double()
        nz = want != 0
        assert torch.equal(got[~nz], want[~nz])
        assert float(((got - want)[nz] / want[nz]).abs().max()) < 1e-4


@pytest.mark.gpu
def test_cuda_wrappers_count_launches_and_reject_cpu_windows(cuda):
    from velociraptor_stf_tpu_torch import kernels

    ctx, ll = _cloud(n=2000)
    kernels.reset_launches()
    KF.detect(ctx.pos.to(cuda), ctx.windows.to(cuda), ll * ll)
    assert kernels.LAUNCHES["fof_detect"] == 1
    with pytest.raises(ValueError):
        KF.detect(ctx.pos.to(cuda), ctx.windows, ll * ll)
    assert kernels.LAUNCHES["fof_detect"] == 1
