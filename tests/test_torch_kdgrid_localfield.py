"""The port's KD median partition (velociraptor_stf_tpu_torch/ops/kdgrid.py)
and local velocity density (models/localfield.py) against the JAX
package's: the permutation exactly equal (planted duplicate coordinates
included), the densities within rtol 1e-4 and the candidate leaves equal,
in the approximate and the exact mode, with and without an active mask.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from velociraptor_stf_tpu.models import localfield as JL
from velociraptor_stf_tpu.ops import kdgrid as JK

from velociraptor_stf_tpu_torch.models import localfield as TL
from velociraptor_stf_tpu_torch.ops import kdgrid as TK
from velociraptor_stf_tpu_torch.ops import segments as tseg
from torch_threads import one_torch_thread  # noqa: F401


def _mock(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    vel = rng.normal(0, 50.0, (n, 3)).astype(np.float32)
    vel[:150] = rng.normal(0, 2.0, (150, 3))          # a cold clump
    pos[100:120] = pos[7]                             # duplicate points
    pos[200:230, 0] = pos[9, 0]                       # duplicate x
    active = rng.uniform(size=n) < 0.8
    return pos, vel, active


@pytest.mark.parametrize("levels", [0, 1, 4, 7])
@pytest.mark.parametrize("masked", [False, True])
def test_median_partition_matches_reference(levels, masked):
    pos, _, active = _mock()
    want = JK.median_partition(jnp.asarray(pos), levels,
                               active=jnp.asarray(active) if masked
                               else None)
    got = TK.median_partition(torch.from_numpy(pos), levels,
                              active=torch.from_numpy(active) if masked
                              else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_median_partition_batch_equals_singles():
    """A batch of sets partitions each set as alone."""
    sets = [_mock(1024, seed=s)[0] for s in range(3)]
    got = TK.median_partition(torch.from_numpy(np.stack(sets)), 5)
    for b, p in enumerate(sets):
        np.testing.assert_array_equal(
            got[b].numpy(), TK.median_partition(torch.from_numpy(p), 5))


def _jax_candidates(pos, active, nsearch=256, leaf_size=32):
    """The JAX velocity_density's candidate leaves (its preamble and
    ``jax.lax.top_k`` selection, recomputed here: the JAX function does
    not return them)."""
    n = pos.shape[0]
    npad = 1 << (n - 1).bit_length()
    nleaf = npad // leaf_size
    m = min(max(2, int(np.ceil(1.5 * nsearch / leaf_size))), nleaf)
    pos = jnp.asarray(pos)
    lo, hi = jnp.min(pos, 0), jnp.max(pos, 0)
    extra = npad - n
    far = hi[None, :] + (jnp.max(hi - lo) + 1.0) * \
        (2.0 + jnp.arange(extra, dtype=pos.dtype))[:, None]
    pos_ext = jnp.concatenate([pos, far])
    act = jnp.ones(n, bool) if active is None else jnp.asarray(active)
    act_ext = jnp.concatenate([act, jnp.zeros(extra, bool)])
    pad_idx = JK.median_partition(pos_ext, int(np.log2(nleaf)),
                                  active=act_ext)
    P = pos_ext[pad_idx].reshape(nleaf, leaf_size, 3)
    valid = (act_ext[pad_idx] & (pad_idx < n)).reshape(nleaf, leaf_size)
    wsum = jnp.maximum(jnp.sum(valid, axis=1), 1)[:, None]
    cm = jnp.sum(jnp.where(valid[..., None], P, 0.0), axis=1) / wsum
    big = jnp.max(hi - lo) * 1e3
    cm = jnp.where(jnp.any(valid, 1)[:, None], cm,
                   hi[None, :] + big * (1 + jnp.arange(
                       nleaf, dtype=pos.dtype))[:, None])
    d2 = jnp.sum((cm[:, None, :] - cm[None, :, :]) ** 2, -1)
    return np.asarray(jax.lax.top_k(-d2, m)[1])


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_velocity_density_matches_reference(exact, masked):
    pos, vel, active = _mock()
    act = active if masked else None
    want = np.asarray(JL.velocity_density(
        jnp.asarray(pos), jnp.asarray(vel), exact=exact,
        active=None if act is None else jnp.asarray(act),
        chunk=256 if exact else 2048))
    got, cand, _ = TL.velocity_density(
        torch.from_numpy(pos), torch.from_numpy(vel), exact=exact,
        active=None if act is None else torch.from_numpy(act),
        return_candidates=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=0)
    np.testing.assert_array_equal(cand.numpy(), _jax_candidates(pos, act))
    if masked:
        assert (got.numpy()[~active] == 0).all()
    # the cold clump stands out
    assert np.median(got.numpy()[:150]) > 3 * np.median(got.numpy()[150:])


def test_velocity_density_chunk_does_not_matter():
    pos, vel, _ = _mock(2048, seed=3)
    a = TL.velocity_density(torch.from_numpy(pos), torch.from_numpy(vel))
    b = TL.velocity_density(torch.from_numpy(pos), torch.from_numpy(vel),
                            chunk=5)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_smallest_k_keeps_index_order_on_ties():
    """``smallest_k`` selects what jax.lax.top_k(-x) selects, ties at the
    boundary and inside the set included."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 6, (200, 40)).astype(np.float32)
    x[:, 5] = np.inf
    for k in (1, 3, 7, 40):
        want = np.asarray(jax.lax.top_k(-jnp.asarray(x), k)[1])
        got = tseg.smallest_k(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(got, want)
