"""Equal-count KD partition by median splits (port of
velociraptor_stf_tpu/ops/kdgrid.py: ``median_partition``).

The leaves of a KD tree are an equal-count, spatially compact partition,
built here with ``levels`` segmented sorts: at each level every current
segment (contiguous, equal size) is sorted stably by its coordinate along
the segment's longest bounding-box axis and split in half.  After L levels
the contiguous blocks of N / 2^L sorted rows are the leaves.

A batch of sets of one size partitions in one pass: the segments of set b
are numbered after those of set b - 1, so every sort and reduction runs
over the whole batch at once.  Ties keep index order (stable sorts; the
first axis of equal extent), as the reference's ``jnp.lexsort`` and
``jnp.argmax`` do.
"""

from __future__ import annotations

from typing import Optional

import torch

_BIG = 3.4e38


def median_partition(pos: torch.Tensor, levels: int,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n,) int64 permutation ordering the (n, d) points ``pos`` into
    2^levels equal-count, spatially compact segments; with ``active``
    the inactive points are moved to the end first (stably), so that
    leaves of real points stay pure.  A (B, n, d) batch gives (B, n)
    permutations, each of its own set."""
    if pos.dim() == 2:
        return median_partition(pos[None], levels,
                                None if active is None else active[None])[0]
    B, n, d = pos.shape
    dev = pos.device
    idx = torch.arange(n, device=dev)
    if active is not None:
        order = torch.argsort((~active).to(torch.int8), dim=1, stable=True)
    else:
        order = idx[None].expand(B, n).contiguous()
    row = torch.arange(B, device=dev)[:, None]
    seg = torch.zeros(B, n, dtype=torch.int64, device=dev)
    for level in range(levels):
        nseg = 1 << level
        p = pos[row, order]                                   # (B, n, d)
        gseg = (seg + row * nseg).reshape(-1)
        pf = p.reshape(-1, d)
        mins = torch.full((B * nseg, d), _BIG, dtype=pos.dtype, device=dev)
        maxs = torch.full((B * nseg, d), -_BIG, dtype=pos.dtype, device=dev)
        gi = gseg[:, None].expand(-1, d)
        mins.scatter_reduce_(0, gi, pf, "amin")
        maxs.scatter_reduce_(0, gi, pf, "amax")
        axis = torch.argmax(maxs - mins, dim=-1)              # (B*nseg,)
        coord = pf.gather(1, axis[gseg][:, None])[:, 0].view(B, n)
        # stable sort by (segment, coordinate) within each set
        perm = torch.argsort(coord, dim=1, stable=True)
        perm = perm.gather(1, torch.argsort(seg.gather(1, perm), dim=1,
                                            stable=True))
        order = order.gather(1, perm)
        seg_sz = n >> (level + 1)
        seg = torch.clamp(idx // max(seg_sz, 1), max=2 * nseg - 1)
        seg = seg[None].expand(B, n)
    return order
