"""Bucket-tree potential for very large groups (port of
velociraptor_stf_tpu/ops/gravity.py: ``_bucket_structure``,
``_bucket_direct_pass``, ``_bucket_far_pass`` and
``bucket_tree_potential_batch``).

A group's K slots are Morton-sorted into C = ceil(K/q) equal-count buckets
of q slots (the order padded to a multiple of q with its last entry).  A
bucket pair is summed particle by particle when ``|cm_a - cm_b| * theta <=
R_a + R_b`` (R = half the diagonal of the bucket's bounding box, the
reference's MarkCell acceptance), and otherwise through the far bucket's
monopole.  Every slot of the Morton order -- including a caller's padding
slots -- shapes the buckets, so the approximation equals the reference's
for the same input.

Unlike the reference, slots a caller marks invalid (``valid``, its zero-mass
padding) contribute exactly nothing and get no potential: the reference adds
``0 * rsqrt(d^2)`` for them, which is NaN when ``eps = 0`` and a padding
copy sits on a real particle.  Pairs whose row or column bucket holds no
valid slot are skipped.  Work proceeds in chunks of a bounded number of
(row, column) terms (``_chunk_elems``); the chunking does not change which
terms are summed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import cells, segments as seg


def _chunk_elems(device: torch.device) -> int:
    """(row, column) terms per chunk: ~0.5 GiB float32 temporaries on a
    card, 16 MiB on the host."""
    return (1 << 27) if device.type == "cuda" else (1 << 22)


def bucket_structure(pos: torch.Tensor, mass: torch.Tensor, q: int,
                     theta: float) -> Tuple[torch.Tensor, ...]:
    """Morton buckets of B groups of K slots, (B, K, 3) / (B, K).

    Returns (pad_idx (B, npad): sorted slot -> input slot, pos_s, mass_s
    (zero on the slots added to reach a multiple of q), bucket centres of
    mass (B, C, 3), bucket masses (B, C), and the (B, C, C) direct
    acceptance, diagonal included)."""
    B, n, _ = pos.shape
    npad = -(-n // q) * q
    cbk = npad // q
    lo = pos.amin(1, keepdim=True)
    hi = pos.amax(1, keepdim=True)
    keys = cells.morton_keys(pos, lo, hi)
    order = torch.argsort(keys, dim=1, stable=True)
    pad_idx = torch.cat([order, order[:, -1:].expand(B, npad - n)], 1)
    pos_s = torch.gather(pos, 1, pad_idx[:, :, None].expand(B, npad, 3))
    mass_s = torch.gather(mass, 1, pad_idx)
    mass_s = torch.where(torch.arange(npad, device=pos.device) < n, mass_s,
                         0.0)
    posr = pos_s.view(B, cbk, q, 3)
    massr = mass_s.view(B, cbk, q)
    bmass = massr.sum(2)
    bcm = (posr * massr[..., None]).sum(2) / \
        torch.clamp_min(bmass, 1e-30)[..., None]
    brad = 0.5 * torch.sqrt(seg.sq3(posr.amax(2) - posr.amin(2)))
    dcm = torch.sqrt(seg.sq3(bcm[:, :, None, :] - bcm[:, None, :, :]))
    direct = dcm * theta <= brad[:, :, None] + brad[:, None, :]
    direct |= torch.eye(cbk, dtype=torch.bool, device=pos.device)
    return pad_idx, pos_s, mass_s, bcm, bmass, direct


def _inv_dist(a: torch.Tensor, b: torch.Tensor, eps2: float
              ) -> torch.Tensor:
    """(..., R, C) 1 / sqrt(|a_r - b_c|^2 + eps2) of (..., R, 3) rows and
    (..., C, 3) columns, |d|^2 summed x, y, z from coordinate differences
    (no |a|^2 + |b|^2 - 2 a.b cancellation), in place."""
    d2 = None
    for k in range(3):
        d = (a[..., :, None, k] - b[..., None, :, k]).square_()
        d2 = d if d2 is None else d2.add_(d)
    if eps2:
        d2.add_(eps2)
    return d2.rsqrt_()


def _direct_pass(pos_s, mass_s, direct, valid_s, q: int, eps2: float,
                 G: float) -> torch.Tensor:
    """(B, npad) sums over the slots of every accepted-direct bucket pair
    (i != j), one dense (q, q) tile per pair."""
    B, npad, _ = pos_s.shape
    cbk = npad // q
    posr = pos_s.view(B, cbk, q, 3)
    massr = mass_s.view(B, cbk, q)
    validr = valid_s.view(B, cbk, q)
    has = validr.any(2)
    # pairs in (lane, a, b) order: each row bucket's pairs are contiguous
    lane, a, b = torch.nonzero(direct & has[:, :, None] & has[:, None, :],
                               as_tuple=True)
    acc = torch.zeros(B * cbk, q, dtype=pos_s.dtype, device=pos_s.device)
    diag = torch.arange(q, device=pos_s.device)
    step = max(1, _chunk_elems(pos_s.device) // (q * q))
    for s in range(0, a.shape[0], step):
        la, aa, bb = lane[s:s + step], a[s:s + step], b[s:s + step]
        w = _inv_dist(posr[la, aa], posr[la, bb], eps2)    # (P, q, q)
        w.mul_(massr[la, bb][:, None, :])
        colv = validr[la, bb]
        part = torch.nonzero(~colv.all(1)).squeeze(1)      # padded buckets
        w[part] = w[part].masked_fill_(~colv[part][:, None, :], 0.0)
        same = torch.nonzero(aa == bb).squeeze(1)
        w[same[:, None], diag[None, :], diag[None, :]] = 0.0   # i == j
        phi = w.sum(2).mul_(-G)                            # (P, q)
        del w
        # one sum per row bucket, added in pair order: no atomics, so
        # the result does not change from run to run on a card
        key, cnt = torch.unique_consecutive(la * cbk + aa,
                                            return_counts=True)
        acc[key] += torch.segment_reduce(phi, "sum", lengths=cnt, axis=0,
                                         unsafe=True)
    return acc.view(B, npad)


def _far_pass(pos_s, bcm, bmass, direct, valid_s, q: int, eps2: float,
              G: float) -> torch.Tensor:
    """(B, npad) monopoles of every non-direct bucket of nonzero mass, for
    the valid slots (0 elsewhere)."""
    B, npad, _ = pos_s.shape
    cbk = npad // q
    out = torch.zeros(B, npad, dtype=pos_s.dtype, device=pos_s.device)
    step = max(1, _chunk_elems(pos_s.device) // max(cbk, 1))
    for lane in range(B):
        rows = torch.nonzero(valid_s[lane]).squeeze(1)
        far_l = ~direct[lane] & (bmass[lane] > 0)[None, :]   # (C, C)
        for s in range(0, rows.shape[0], step):
            r = rows[s:s + step]
            w = _inv_dist(pos_s[lane, r], bcm[lane], eps2)   # (R, C)
            w.mul_(bmass[lane][None, :]).masked_fill_(~far_l[r // q], 0.0)
            out[lane, r] = w.sum(1).mul_(-G)
    return out


def bucket_tree_potential_batch(posb: torch.Tensor, massb: torch.Tensor,
                                eps2: float, G: float, q: int = 1024,
                                theta: float = 0.4,
                                valid: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """(B, K, 3) / (B, K) -> (B, K) potential Phi of every slot of each
    group due to the group's other slots (-G m_j / sqrt(d^2 + eps2),
    scaled by G; the caller multiplies by the slot's mass).  ``valid``
    (B, K) marks the slots that are real particles (default: all); the
    others contribute nothing and get 0."""
    B, K, _ = posb.shape
    if valid is None:
        valid = torch.ones(B, K, dtype=torch.bool, device=posb.device)
    # at most 2^24 slots per batch: the (B, C, C) bucket-pair tables grow
    # as K^2 / q^2 per group
    bc = max(1, (1 << 24) // max(K, 1))
    if B > bc:
        return torch.cat([bucket_tree_potential_batch(
            posb[i:i + bc], massb[i:i + bc], eps2, G, q, theta,
            valid[i:i + bc]) for i in range(0, B, bc)])
    eps2 = float(np.float32(eps2))      # added in float32, as the reference
    pad_idx, pos_s, mass_s, bcm, bmass, direct = bucket_structure(
        posb, massb, q, theta)
    npad = pad_idx.shape[1]
    valid_s = torch.gather(valid, 1, pad_idx) & \
        (torch.arange(npad, device=posb.device) < K)
    w = _direct_pass(pos_s, mass_s, direct, valid_s, q, eps2, G) + \
        _far_pass(pos_s, bcm, bmass, direct, valid_s, q, eps2, G)
    out = torch.zeros(B, K, dtype=posb.dtype, device=posb.device)
    out.scatter_(1, pad_idx[:, :K], w[:, :K])
    return torch.where(valid, out, 0.0)
