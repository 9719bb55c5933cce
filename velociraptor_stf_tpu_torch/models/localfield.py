"""Local velocity density (port of velociraptor_stf_tpu/models/localfield.py:
``_leaf_densities`` and ``velocity_density``).

Reference ``GetVelocityDensity`` (localfield.cxx:18) in its approximative
mode (:726), the production default: the particles are split into KD
leaves of ``leaf_size`` (``ops/kdgrid.py::median_partition``); each leaf
takes the ``cand_leaves`` leaves nearest its centre as candidates, keeps
the ``nsearch`` candidates nearest that centre as one shared set, and each
of its particles sums an SPH (Epanechnikov) kernel over its ``nvel``
nearest velocity neighbours in that set.  The exact mode
(``Local_velocity_density_approximate_calculation = 0``, :485) ranks the
candidates by each particle's own distance instead.

Every selection whose indices are used keeps the reference's tie order
(``ops/segments.py::smallest_k``); the leaves are processed in chunks of
leaves sized so that a chunk's (chunk, leaves) distance block stays under
``_BLOCK`` elements.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..ops import segments as seg
from ..ops.kdgrid import median_partition

_BLOCK = 1 << 27     # elements of one chunk's leaf-to-leaf distance block


def _leaf_densities(P, V, valid, cm, nvel: int, nsearch: int, m: int,
                    chunk: int, exact: bool, cand_out=None,
                    pool=None) -> torch.Tensor:
    """(L, K) SPH velocity densities of the (L, K, 3) leaf particles ``P``
    / ``V`` (validity (L, K), selection centres (L, 3), empty leaves parked
    far away) against the same leaves as candidate pool, or against
    ``pool`` = (P, V, valid, cm) of other leaves (a shard's own and its
    neighbours', ``parallel/distributed_localfield.py``).  ``cand_out``:
    an (L, m) int64 tensor to receive each leaf's candidate leaves."""
    nleaf, leaf_size = P.shape[0], P.shape[1]
    Pp, Vp, validp, cmp_ = (P, V, valid, cm) if pool is None else pool
    out = torch.empty(nleaf, leaf_size, dtype=P.dtype, device=P.device)
    for s in range(0, nleaf, chunk):
        l = torch.arange(s, min(s + chunk, nleaf), device=P.device)
        B = l.shape[0]
        c = cm[l]                                               # (B, 3)
        d2leaf = seg.sq3(c[:, None, :] - cmp_[None, :, :])      # (B, L)
        cand_l = seg.smallest_k(d2leaf, m)                      # (B, M)
        del d2leaf
        if cand_out is not None:
            cand_out[l] = cand_l
        cand_pos = Pp[cand_l].reshape(B, m * leaf_size, 3)
        cand_vel = Vp[cand_l].reshape(B, m * leaf_size, 3)
        cand_valid = validp[cand_l].reshape(B, m * leaf_size)
        if exact:
            d2p = seg.sq3(P[l][:, :, None, :] - cand_pos[:, None, :, :])
            d2p = torch.where(cand_valid[:, None, :], d2p, math.inf)
            selp = seg.smallest_k(d2p, nsearch)                # (B, K, Ns)
            sel_vel = torch.gather(
                cand_vel[:, None].expand(-1, leaf_size, -1, -1), 2,
                selp[..., None].expand(-1, -1, -1, 3))
            sel_valid = torch.gather(
                cand_valid[:, None].expand(-1, leaf_size, -1), 2, selp)
            dv2 = seg.sq3(V[l][:, :, None, :] - sel_vel)
            dv2 = torch.where(sel_valid, dv2, math.inf)
        else:
            d2cm = seg.sq3(cand_pos - c[:, None, :])
            d2cm = torch.where(cand_valid, d2cm, math.inf)
            sel = seg.smallest_k(d2cm, nsearch)                 # (B, Ns)
            sel_vel = torch.gather(cand_vel, 1,
                                   sel[..., None].expand(-1, -1, 3))
            sel_valid = torch.gather(cand_valid, 1, sel)
            dv2 = seg.sq3(V[l][:, :, None, :] - sel_vel[:, None, :, :])
            dv2 = torch.where(sel_valid[:, None, :], dv2, math.inf)
        # only the values are used: the plain top-k order is enough
        dvk = torch.topk(dv2, nvel + 1, dim=-1, largest=False,
                         sorted=True).values
        is_self = dvk[..., :1] <= 0.0
        dsel = torch.where(is_self, dvk[..., 1:nvel + 1], dvk[..., 0:nvel])
        fin = torch.isfinite(dsel)
        h2 = torch.clamp_min(torch.amax(torch.where(fin, dsel, 0.0), -1),
                             1e-30)
        u2 = dsel / h2[..., None]
        kern = torch.clamp_min(1.0 - u2, 0.0)
        h3 = h2 * torch.sqrt(h2)
        out[l] = 15.0 / (8.0 * math.pi) / h3 * torch.sum(
            torch.where(fin, kern, 0.0), -1)
    return out


def velocity_density(pos: torch.Tensor, vel: torch.Tensor, nvel: int = 32,
                     nsearch: int = 256, leaf_size: int = 32,
                     cand_leaves: Optional[int] = None,
                     chunk: Optional[int] = None,
                     active: Optional[torch.Tensor] = None,
                     exact: bool = False,
                     return_candidates: bool = False):
    """(N,) local velocity density of each particle (0 for inactive ones,
    which are left out of every candidate set: reference STRUCDEN,
    localfield.cxx:806).  ``exact``: per-particle candidate ranking.
    ``chunk``: leaves per step (default: as many as ``_BLOCK`` allows,
    at most 2048; the result does not depend on it).
    ``return_candidates``: also return the (nleaf, m) candidate leaves
    and the (npad,) leaf permutation."""
    n = pos.shape[0]
    dev = pos.device
    npad = 1
    while npad < n:
        npad *= 2
    nleaf = max(npad // leaf_size, 1)
    if cand_leaves is None:
        cand_leaves = max(2, int(np.ceil(1.5 * nsearch / leaf_size)))
    m = min(cand_leaves, nleaf)
    nsearch = min(nsearch, m * leaf_size)
    nvel = min(nvel, nsearch - 1)
    if chunk is None:
        chunk = max(1, min(2048, _BLOCK // max(nleaf, 1)))
        if exact:
            chunk = max(1, min(chunk, _BLOCK // (leaf_size * m * leaf_size)))

    lo = pos.amin(0)
    hi = pos.amax(0)
    # pow2 padding parked far away so the KD leaves stay pure
    extra = npad - n
    far = hi[None, :] + (torch.amax(hi - lo) + 1.0) * \
        (2.0 + torch.arange(extra, dtype=pos.dtype, device=dev))[:, None]
    pos_ext = torch.cat([pos, far])
    vel_ext = torch.cat([vel, vel.new_zeros(extra, 3)])
    act = active if active is not None else \
        torch.ones(n, dtype=torch.bool, device=dev)
    act_ext = torch.cat([act, act.new_zeros(extra)])
    levels = int(np.log2(nleaf)) if nleaf > 1 else 0
    pad_idx = median_partition(pos_ext, levels, active=act_ext)
    P = pos_ext[pad_idx].reshape(nleaf, leaf_size, 3)
    V = vel_ext[pad_idx].reshape(nleaf, leaf_size, 3)
    valid = (act_ext[pad_idx] & (pad_idx < n)).reshape(nleaf, leaf_size)

    wsum = torch.clamp_min(valid.sum(1), 1)[:, None].to(pos.dtype)
    cm = torch.where(valid[..., None], P, 0.0).sum(1) / wsum
    leaf_ok = valid.any(1)
    big = torch.amax(hi - lo) * 1e3
    cm_sel = torch.where(
        leaf_ok[:, None], cm,
        hi[None, :] + big * (1 + torch.arange(nleaf, dtype=pos.dtype,
                                              device=dev))[:, None])
    cand = torch.empty(nleaf, m, dtype=torch.int64, device=dev) \
        if return_candidates else None
    dens_leaf = _leaf_densities(P, V, valid, cm_sel, nvel, nsearch, m,
                                chunk, exact, cand_out=cand)
    vflat = valid.reshape(-1)
    out = torch.zeros(n, dtype=pos.dtype, device=dev)
    out[pad_idx[vflat]] = dens_leaf.reshape(-1)[vflat]
    if return_candidates:
        return out, cand, pad_idx
    return out
