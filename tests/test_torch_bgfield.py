"""The port's background grid and outlier values (velociraptor_stf_tpu_torch/
models/bgfield.py) against the JAX package's: cell positions and mean
velocities within rtol 1e-5 and inverse dispersions within 1e-4 for both
grid types, R from the dense and the bucketed nearest-cell search within
atol 1e-4, mode and dispersions within rtol 1e-4 and ell within rtol and
atol 2e-4 (the JAX package's own batch tolerance,
tests/test_substructure.py:392); the fit against the float64 oracle as
tests/test_oracles.py:138 holds the JAX package to it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from velociraptor_stf_tpu.models import bgfield as JB
from velociraptor_stf_tpu.models import substructure as JS
from velociraptor_stf_tpu.utils import config as C

from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.models import bgfield as TB
from velociraptor_stf_tpu_torch.models import substructure as TS
from velociraptor_stf_tpu_torch.validation.oracles import outlier_fit_oracle
from torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol, atol_frac=0.0):
    want = np.asarray(want)
    atol = atol_frac * np.abs(want).max(initial=0.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def _field(n, seed, stream=False):
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 100.0, (n, 3)).astype(np.float32)
    if stream:                       # a cold co-spatial stream
        vel[:n // 8] = np.array([500.0, 0, 0]) + \
            rng.normal(0, 2.0, (n // 8, 3))
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return pos, vel, mass


@pytest.mark.parametrize("gridtype", [1, 2])
def test_background_grid_matches_reference(gridtype):
    pos, vel, mass = _field(5000, 1, stream=True)
    want = JB.background_grid(jnp.asarray(pos), jnp.asarray(vel),
                              jnp.asarray(mass), 150, gridtype=gridtype)
    got = TB.background_grid(_t(pos), _t(vel), _t(mass), 150,
                             gridtype=gridtype)
    _close(got[0], want[0], 1e-5, 1e-6)
    _close(got[1], want[1], 1e-5, 1e-6)      # mean velocities near 0
    _close(got[2], want[2], 1e-4, 1e-5)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    # a batch of one size gives each set its own grid
    b = TB.background_grid(_t(np.stack([pos, pos[::-1]])),
                           _t(np.stack([vel, vel[::-1]])),
                           _t(np.stack([mass, mass[::-1]])), 150,
                           gridtype=gridtype)
    np.testing.assert_array_equal(b[0][0].numpy(), got[0].numpy())


@pytest.mark.parametrize("path", ["dense", "bucketed", "switch"])
def test_denv_ratio_matches_reference(path):
    """Both nearest-cell searches against the JAX functions themselves
    (tests/test_substructure.py:308's input)."""
    rng = np.random.default_rng(9)
    n, C_ = 20000, 512
    pos, vel, _ = _field(n, 9)
    mass = np.ones(n, np.float32)
    grid = JB.background_grid(jnp.asarray(pos), jnp.asarray(vel),
                              jnp.asarray(mass), n // C_)
    dens = rng.uniform(0.5, 2.0, n).astype(np.float32)
    args = (jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(dens)) + \
        tuple(grid[:3])
    targs = tuple(_t(np.asarray(a)) for a in args)
    if path == "dense":
        want, got = JB._denv_ratio_dense(*args, 32), \
            TB._denv_ratio_dense(*targs, 32)
    elif path == "bucketed":
        want, got = JB._denv_ratio_bucketed(*args, 32), \
            TB._denv_ratio_bucketed(*targs, 32)
    else:
        want, got = JB.denv_ratio(*args, 32), TB.denv_ratio(*targs, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def _skewed(n, seed, tail=0.02):
    rng = np.random.default_rng(seed)
    side = rng.uniform(size=n) < 0.6 / 1.7
    R = np.where(side, 0.4 - np.abs(rng.normal(0, 0.6, n)),
                 0.4 + np.abs(rng.normal(0, 1.1, n)))
    nt = int(n * tail)
    R[:nt] = rng.uniform(4.0, 8.0, nt)
    return R.astype(np.float32)


@pytest.mark.parametrize("n,masked,masses", [
    (3000, False, "equal"),       # below the fit's gate: histogram only
    (30000, False, "equal"),      # the skew-Gaussian fit
    (30000, True, "unequal")])
def test_outlier_values_matches_reference(n, masked, masses):
    rng = np.random.default_rng(n)
    R = _skewed(n, 17)
    mass = np.ones(n, np.float32) if masses == "equal" else \
        rng.choice([1.0, 0.6], n).astype(np.float32)
    active = rng.uniform(size=n) < 0.9 if masked else np.ones(n, bool)
    ell_j, stats_j = JB.outlier_values(jnp.asarray(R), jnp.asarray(mass),
                                       active=jnp.asarray(active))
    ell_t, stats_t = TB.outlier_values(_t(R), _t(mass), active=_t(active))
    for g, w in zip(stats_t, stats_j):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-4)
    np.testing.assert_allclose(ell_t.numpy(), np.asarray(ell_j), rtol=2e-4,
                               atol=2e-4)


def test_outlier_values_batch_equals_singles():
    sets = [_skewed(20000, s) for s in (1, 2, 3)]
    mass = np.ones(20000, np.float32)
    ell_b, (mode_b, _, _) = TB.outlier_values(_t(np.stack(sets)),
                                              _t(np.stack([mass] * 3)))
    for b, R in enumerate(sets):
        ell, (mode, _, _) = TB.outlier_values(_t(R), _t(mass))
        np.testing.assert_allclose(ell_b[b].numpy(), ell.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(mode_b[b]), float(mode),
                                   rtol=1e-5)


def test_outlier_fit_matches_oracle():
    """tests/test_oracles.py:138's planted skew Gaussian with a 2% tail:
    the port's fit against the float64 oracle (scipy LM), with the JAX
    package's tolerances."""
    rng = np.random.default_rng(17)
    n = 60000
    mu_t, sdlow_t, sdhigh_t = 0.4, 0.6, 1.1
    side = rng.uniform(size=n) < sdlow_t / (sdlow_t + sdhigh_t)
    R = np.where(side, mu_t - np.abs(rng.normal(0, sdlow_t, n)),
                 mu_t + np.abs(rng.normal(0, sdhigh_t, n)))
    ntail = n // 50
    R[:ntail] = rng.uniform(4.0, 8.0, ntail)
    mass = np.ones(n)
    mode_o, sdl_o, sdh_o, ell_o = outlier_fit_oracle(R, mass)
    ell, (mode, sdl, sdh) = TB.outlier_values(_t(R.astype(np.float32)),
                                              _t(mass.astype(np.float32)))
    assert abs(float(mode) - mode_o) < 0.2
    assert abs(float(sdl) - sdl_o) / sdl_o < 0.3
    assert abs(float(sdh) - sdh_o) / sdh_o < 0.3
    sel_o, sel = ell_o > 2.5, ell.numpy() > 2.5
    assert (sel_o != sel).mean() < 0.02
    assert sel[:ntail].mean() > 0.95


def test_structure_outliers_matches_reference():
    """A padded structure end to end (grid, R, ell) with its own density,
    as the halo-local mode runs it."""
    from velociraptor_stf_tpu_torch.io.synthetic import host_with_subhalo

    pos, vel, mass, member = host_with_subhalo(seed=3, nhost=3000, nsub=400)
    ppos, pvel, pmass, valid = JS._pad_structure(pos, vel, mass, 4096, 0.15)
    opt = C.Options()
    ell_j, dens_j, _ = JS.structure_outliers(opt, ppos, pvel, pmass, valid)
    ell_t, dens_t, _ = TS.structure_outliers(convert.options(opt), _t(ppos),
                                             _t(pvel), _t(pmass), _t(valid))
    np.testing.assert_allclose(dens_t.numpy(), np.asarray(dens_j),
                               rtol=1e-4)
    fin = np.isfinite(np.asarray(ell_j))
    np.testing.assert_array_equal(np.isfinite(ell_t.numpy()), fin)
    np.testing.assert_allclose(ell_t.numpy()[fin], np.asarray(ell_j)[fin],
                               rtol=2e-4, atol=2e-4)
    assert np.median(ell_t.numpy()[:len(pos)][member]) > 1.0


def test_one_fit_over_batches_of_two_widths():
    """The recursion fits a level at once: batches of two set sizes (two
    bin counts) refined together give each batch's own fit."""
    a = np.stack([_skewed(20000, s) for s in (1, 2)])
    b = _skewed(70000, 3)[None]
    alone = [TB.outlier_values(_t(x), _t(np.ones_like(x)))[1] for x in (a, b)]
    dists = [TB.distribution(_t(x), _t(np.ones_like(x)),
                             _t(np.ones_like(x, dtype=bool))) for x in (a, b)]
    assert dists[0][3][1].shape[1] != dists[1][3][1].shape[1]
    TB.refine(dists)
    for d, st in zip(dists, alone):
        for g, w in zip(d[:3], st):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5)
