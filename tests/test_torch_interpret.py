"""The port's plain kernel versions (velociraptor_stf_tpu_torch/kernels:
detect_ref, sweep3d_ref, sweep6d_ref, potential_ref) against the JAX
package's Pallas kernels themselves, run by the TPU interpreter on the CPU
as tests/test_pallas_interpret.py runs them.

Both sides see the same cell-sorted slots (the context test of
test_torch_fof.py pins the slot order), so per-slot results compare
directly: counts and labels exactly, the potential within rel 1e-4.  The
Pallas sweeps scan a block's windows, the port's plain sweeps each row's
own cell windows: the same function over other candidate sets.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from velociraptor_stf_tpu.io.synthetic import make_cosmo_mock
from velociraptor_stf_tpu.ops import pallas_fof as PF
from velociraptor_stf_tpu.ops import pallas_gravity as PG

from velociraptor_stf_tpu_torch.kernels import fof_sweep as KF
from velociraptor_stf_tpu_torch.kernels import potential as KP
from velociraptor_stf_tpu_torch.models import halos as thalos
from velociraptor_stf_tpu_torch.ops import fof_sweep as TF
from velociraptor_stf_tpu_torch.ops import gravity_direct
from velociraptor_stf_tpu_torch.ops import segments as tseg

pytestmark = pytest.mark.slow   # the TPU interpreter is minutes-scale

BOX = 16.0
N = 4096


@pytest.fixture(scope="module")
def box():
    pos, vel, mass = make_cosmo_mock(N, boxsize=BOX, nhalos=4, seed=9)
    b = 0.2 * BOX / N ** (1 / 3)
    jctx = PF.build_fof_ctx(jnp.asarray(pos), jnp.asarray(vel), BOX, b)
    tctx, _ = TF.build_fof_ctx(torch.from_numpy(pos), BOX, b)
    np.testing.assert_array_equal(np.asarray(jctx.src)[:tctx.ns],
                                  tctx.src.numpy())
    return pos, vel, mass, b, jctx, tctx


def test_detect_matches_pallas(box, monkeypatch):
    monkeypatch.setenv("VR_FOF_PALLAS", "1")
    _, _, _, b, jctx, tctx = box
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(PF._make_detect_3d(jctx.ns_pad, b * b)(
            jctx.ranges, jctx.cols_p, jctx.cols_p))[0, :tctx.ns]
    _, ny, nz = tctx.ncells
    col, colstart = tctx.detect_index
    got = KF.detect_ref(KF.pack(tctx.pos.T, (tctx.cr % nz).int()), col,
                        colstart, ny, KF.f32(b * b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 1).all() and (got >= 2).any()


def test_linked_mask_matches_pallas(box, monkeypatch):
    """``SweepFof.linked_mask`` (detect through the column index, ghost
    rows folded into their source) against the JAX ``_linked_mask`` with
    its Pallas detect kernel in the interpreter."""
    monkeypatch.setenv("VR_FOF_PALLAS", "1")
    pos, vel, _, b, jctx, _ = box
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(PF._linked_mask(jctx, jctx.ns_pad, b * b)[0])
    fof = TF.SweepFof(torch.from_numpy(pos), torch.from_numpy(vel), BOX, b)
    keep, nkeep = fof.linked_mask(b)
    np.testing.assert_array_equal(keep.numpy(), want)
    assert 0 < nkeep == int(want.sum()) < N


def test_sweep3d_matches_pallas(box, monkeypatch):
    monkeypatch.setenv("VR_FOF_PALLAS", "1")
    _, _, _, b, jctx, tctx = box
    labels = jnp.arange(jctx.ns_pad, dtype=jnp.int32)
    merged = jctx.cols_p.at[3, :jctx.ns_pad].set(labels)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(PF._make_sweep_3d(jctx.ns_pad, b * b)(
            jctx.ranges, merged, merged))[0, :tctx.ns]
    lab = torch.arange(tctx.ns, dtype=torch.int32)
    cell, win = tctx.sweep_windows
    got = KF.sweep3d_ref(KF.pack(tctx.pos.T), lab, cell, win, KF.f32(b * b))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got < lab).any()


def test_sweep6d_matches_pallas(box, monkeypatch):
    monkeypatch.setenv("VR_FOF_PALLAS", "1")
    pos, vel, mass, b, jctx, tctx = box
    # 3DFOF groups and the FOF6D velocity scale of the port
    fof = TF.SweepFof(torch.from_numpy(pos), torch.from_numpy(vel), BOX, b)
    pfof3, ng3 = fof.fof3d(b, 20)
    assert ng3 > 0
    vs = thalos.velocity_scale_largest_group(
        torch.from_numpy(vel), torch.from_numpy(mass), pfof3, ng3 + 1, 1.25)
    vs2 = torch.where(pfof3 > 0, vs, 1.0)
    inv_b2 = 1.0 / b ** 2

    ctx = PF._fill_vel(jctx, jnp.asarray(vel))
    ns_pad = ctx.ns_pad
    safe = jnp.where(ctx.src >= 0, ctx.src, 0)
    grp = jnp.where(ctx.src >= 0, jnp.asarray(pfof3.numpy(), jnp.int32)[safe],
                    0)
    ivs = jnp.where(ctx.src >= 0,
                    1.0 / jnp.maximum(jnp.asarray(vs2.numpy())[safe], 1e-30),
                    1.0).astype(jnp.float32)
    base = jnp.concatenate([
        ctx.cols_p[0:3],
        jax.lax.bitcast_convert_type(ctx.cols_v[0:3], jnp.int32),
        jax.lax.bitcast_convert_type(
            jnp.concatenate([ivs, jnp.ones(PF.CH, jnp.float32)]),
            jnp.int32)[None, :],
        jnp.concatenate([grp, jnp.zeros(PF.CH, jnp.int32)])[None, :]], 0)
    labels = jnp.arange(ns_pad, dtype=jnp.int32)
    lab_col = jnp.concatenate([labels, jnp.full(PF.CH, PF.BIG_I32,
                                                jnp.int32)])[None, :]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(PF._make_sweep_6d(ns_pad, inv_b2)(
            ctx.ranges, base, labels[None, :], base, lab_col))[0, :tctx.ns]

    src = tctx.src
    rivs = 1.0 / torch.clamp_min(vs2[src], 1e-30)
    lab = torch.arange(tctx.ns, dtype=torch.int32)
    cell, win = tctx.sweep_windows
    got = KF.sweep6d_ref(KF.pack(tctx.pos.T, pfof3[src].int()),
                         KF.pack(torch.from_numpy(vel)[src], rivs), lab,
                         cell, win, KF.f32(inv_b2))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got < lab).any()


def test_potential_matches_pallas(box, monkeypatch):
    monkeypatch.setenv("VR_POT_PALLAS", "1")
    pos, vel, mass, b, _, _ = box
    fof = TF.SweepFof(torch.from_numpy(pos), torch.from_numpy(vel), BOX, b)
    pfof, ng = fof.fof3d(b, 20)
    assert ng > 0
    upos = tseg.unwrap_positions(torch.from_numpy(pos), pfof, BOX, ng)
    perm = tseg.sort_by_group(pfof)
    g_s = pfof[perm]
    offsets = tseg.group_offsets(g_s, ng)
    pos_s, mass_s = upos[perm], torch.from_numpy(mass)[perm]
    eps2 = 1e-4
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(PG.potential_group_sorted(
            jnp.asarray(pos_s.numpy()), jnp.asarray(mass_s.numpy()),
            jnp.asarray(g_s.numpy(), jnp.int32),
            jnp.asarray(offsets.numpy(), jnp.int32),
            -(-N // PG.R_BLOCK) * PG.R_BLOCK, eps2), np.float64)
    got = KP.potential_ref(pos_s.T.contiguous(), mass_s, g_s.int(),
                           gravity_direct.block_window(g_s, offsets),
                           KP.f32(eps2)).numpy().astype(np.float64)
    nz = want != 0
    assert nz.sum() > 100
    np.testing.assert_array_equal(got[~nz], 0.0)
    assert np.max(np.abs(got[nz] - want[nz]) / np.abs(want[nz])) < 1e-4
