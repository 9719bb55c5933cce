"""Segmented (per-group) tensor operations (port of the helpers of
velociraptor_stf_tpu/ops/segments.py that the main path uses).

Segment sums add each segment's elements in index order with
``torch.segment_reduce`` over the values sorted (stably) by segment: on the
CPU that is the reference's sequential scatter-add order, so float32 sums
round identically, and on a GPU the result does not depend on the run
(atomics would add in a different order every time).  Where the reference
compacts with padded capacities (``compact_mask``, ``gather_rows``), the
port indexes with ``torch.nonzero`` and plain gathers.
"""

from __future__ import annotations

import torch


def pad_class(x: int, lo: int = 1024, align: int = 1024) -> int:
    """The reference's capacity class for ``x`` elements: the smallest
    2^k x {1, 1.25, 1.5, 1.75} >= x (align-rounded).  The port sizes
    nothing by it; the ejection loop uses it only to start its per-group
    sums afresh at the same iterations as the reference (models/unbind.py)."""
    k = lo
    while k < x:
        k *= 2
    if k <= lo:
        return k
    h = k // 2
    for frac in (5, 6, 7):
        cand = -(-(h * frac // 4) // align) * align
        if cand >= x:
            return cand
    return k


def sq3(d: torch.Tensor) -> torch.Tensor:
    """|d|^2 over a last axis of size 3, summed x, y, z in order, as the
    reference's float32 sums round."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + \
        d[..., 2] * d[..., 2]


def group_sizes(pfof: torch.Tensor, num_groups: int) -> torch.Tensor:
    """(num_groups+1,) int64 member count per group id (id 0 = untagged)."""
    return torch.bincount(torch.clamp(pfof, 0, num_groups),
                          minlength=num_groups + 1)


def segment_count(mask: torch.Tensor, seg: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """(num_segments,) int64 number of True entries of ``mask`` per
    segment."""
    return torch.bincount(seg[mask], minlength=num_segments)


def segment_sum(values: torch.Tensor, seg: torch.Tensor, num_segments: int,
                presorted: bool = False) -> torch.Tensor:
    """Per-segment sum along axis 0 (0 for an empty segment), each segment
    added in index order.  ``presorted``: ``seg`` is already
    non-decreasing."""
    if not presorted:
        order = torch.argsort(seg, stable=True)
        values, seg = values[order], seg[order]
    lengths = torch.bincount(seg, minlength=num_segments)
    if values.dim() == 1:
        return torch.segment_reduce(values, "sum", lengths=lengths,
                                    unsafe=True)
    return torch.stack([torch.segment_reduce(
        values[:, j].contiguous(), "sum", lengths=lengths, unsafe=True)
        for j in range(values.shape[1])], -1)


def segment_mean(values: torch.Tensor, weights: torch.Tensor,
                 seg: torch.Tensor, num_segments: int,
                 presorted: bool = False) -> torch.Tensor:
    """Weighted per-segment mean along axis 0."""
    if not presorted:
        order = torch.argsort(seg, stable=True)
        values, weights, seg = values[order], weights[order], seg[order]
    w = weights[:, None] if values.dim() > 1 else weights
    num = segment_sum(values * w, seg, num_segments, presorted=True)
    den = torch.clamp_min(segment_sum(weights, seg, num_segments,
                                      presorted=True), 1e-30)
    return num / (den[:, None] if values.dim() > 1 else den)


def segment_outer(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
                  seg: torch.Tensor, num_segments: int,
                  presorted: bool = False) -> torch.Tensor:
    """(num_segments, 3, 3) per-segment sum of w_i a_i (x) b_i, as nine
    component sums in index order."""
    if not presorted:
        order = torch.argsort(seg, stable=True)
        a, b, w, seg = a[order], b[order], w[order], seg[order]
    cols = torch.stack([a[:, i] * b[:, j] * w for i in range(3)
                        for j in range(3)], -1)
    return segment_sum(cols, seg, num_segments,
                       presorted=True).view(num_segments, 3, 3)


def segment_cumsum(values: torch.Tensor, seg_sorted: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum within contiguous segments of the
    non-decreasing ``seg_sorted`` (``offsets`` from ``group_offsets``).

    The running total is kept in float64 and each segment's start is
    subtracted before rounding back to the values' dtype, so every
    segment's sums are those of its own elements to float64 accuracy,
    whatever the length of the array before it."""
    total = torch.cumsum(values.double(), 0)
    starts = offsets[seg_sorted]
    base = torch.where(starts > 0, total[torch.clamp_min(starts - 1, 0)],
                       0.0)
    return (total - base).to(values.dtype)


def segment_max(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment maximum (the dtype's lowest value for empty
    segments); max does not depend on the order of the elements."""
    low = (torch.iinfo(values.dtype).min if not values.is_floating_point()
           else float("-inf"))
    out = torch.full((num_segments,), low, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, seg, values, "amax")


def segment_min(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment minimum (the dtype's maximum for empty segments)."""
    big = (torch.iinfo(values.dtype).max if not values.is_floating_point()
           else float("inf"))
    out = torch.full((num_segments,), big, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, seg, values, "amin")


def lexsort2(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by (``major``, ``minor``), ties in index order:
    ``jnp.lexsort((minor, major))`` as two stable argsorts."""
    order = torch.argsort(minor, stable=True)
    return order[torch.argsort(major[order], stable=True)]


def segment_argmin(values: torch.Tensor, seg: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """Index (into the full array) of the first per-segment minimum;
    n for empty segments."""
    n = values.shape[0]
    vmin = segment_min(values, seg, num_segments)
    idx = torch.arange(n, device=values.device)
    return segment_min(torch.where(values == vmin[seg], idx, n), seg,
                       num_segments)


def sort_by_group(pfof: torch.Tensor) -> torch.Tensor:
    """Stable permutation sorting particles by group id (group 0 first,
    original order within a group)."""
    return torch.argsort(pfof, stable=True)


def group_offsets(pfof_sorted: torch.Tensor, num_groups: int
                  ) -> torch.Tensor:
    """(num_groups+2,) start of each group id in group-sorted order:
    group g occupies [offsets[g], offsets[g+1])."""
    ids = torch.arange(num_groups + 2, dtype=pfof_sorted.dtype,
                       device=pfof_sorted.device)
    return torch.searchsorted(pfof_sorted, ids)


def segment_rank(seg_sorted: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    """0-based rank of each element within its contiguous segment."""
    n = seg_sorted.shape[0]
    return torch.arange(n, device=seg_sorted.device) - offsets[seg_sorted]


def unwrap_positions(pos: torch.Tensor, pfof: torch.Tensor, boxsize: float,
                     num_groups: int) -> torch.Tensor:
    """Map each group's members to the minimum image about its lowest-index
    member (reference AdjustStructureForPeriod); group 0 is left as is.
    ``torch.round`` rounds half to even, like ``jnp.round``."""
    n = pos.shape[0]
    first = segment_argmin(torch.arange(n, device=pos.device), pfof,
                           num_groups + 1)
    ref = pos[torch.clamp(first[torch.clamp(pfof, 0, num_groups)], 0, n - 1)]
    d = pos - ref
    d = d - boxsize * torch.round(d / boxsize)
    return torch.where((pfof > 0)[:, None], ref + d, pos)
