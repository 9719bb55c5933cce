"""Segmented (per-group) tensor operations (port of the helpers of
velociraptor_stf_tpu/ops/segments.py), and ``smallest_k``, the port's
stand-in for ``jax.lax.top_k`` with its tie order.

Segment sums add each segment's elements in index order with
``torch.segment_reduce`` over the values sorted (stably) by segment: on the
CPU that is the reference's sequential scatter-add order, so float32 sums
round identically, and on a GPU the result does not depend on the run
(atomics would add in a different order every time) nor on where a
segment lies in the array (each is reduced from an aligned start).
Where the reference compacts with padded capacities (``compact_mask``,
``gather_rows``), the port indexes with ``torch.nonzero`` and plain
gathers.  ``pair_counts`` and ``renumber_segments`` take a segment key
(the structure of a row in the recursion's batched subset search), so one
sort serves every structure of a batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


# a segment's first element sits at a multiple of this many elements
# before a CUDA segment_reduce (see ``segment_sum``)
_ALIGN = 16


def _aligned_segments(values: torch.Tensor, seg: torch.Tensor,
                      lengths: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted ``values`` copied so that every segment starts at a multiple
    of ``_ALIGN`` elements (zeros after each segment, and a last filler
    segment): the CUDA segment reduction loads vectors from a segment's
    start, so its float sums depend on that start's alignment.  No host
    sync: the copy has the fixed size n + _ALIGN * (segments + 1)."""
    n, ns = values.shape[0], lengths.shape[0]
    padded = (lengths + _ALIGN - 1) // _ALIGN * _ALIGN
    start = torch.cumsum(padded, 0) - padded
    first = torch.cumsum(lengths, 0) - lengths
    size = n + _ALIGN * (ns + 1)
    out = values.new_zeros((size,) + tuple(values.shape[1:]))
    out[torch.arange(n, device=values.device) - first[seg] + start[seg]] = \
        values
    return out, torch.cat([padded, (size - padded.sum()).reshape(1)])


def segment_sum(values: torch.Tensor, seg: torch.Tensor, num_segments: int,
                presorted: bool = False) -> torch.Tensor:
    """Per-segment sum along axis 0 (0 for an empty segment), each segment
    added in index order.  ``presorted``: ``seg`` is already
    non-decreasing.  On a GPU each segment is reduced from an aligned
    start (``_aligned_segments``), so its sum depends on its own elements
    only, not on where it lies in the array (a shard's block or the whole
    set)."""
    if not presorted:
        order = torch.argsort(seg, stable=True)
        values, seg = values[order], seg[order]
    lengths = torch.bincount(seg, minlength=num_segments)
    if values.is_cuda:
        values, lengths = _aligned_segments(values, seg, lengths)
    if values.dim() == 1:
        out = torch.segment_reduce(values, "sum", lengths=lengths,
                                   unsafe=True)
    else:
        out = torch.stack([torch.segment_reduce(
            values[:, j].contiguous(), "sum", lengths=lengths, unsafe=True)
            for j in range(values.shape[1])], -1)
    return out[:num_segments]


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


def smallest_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` smallest entries along the last axis in
    ascending order, equal values in index order: what
    ``jax.lax.top_k(-x, k)`` selects.  ``torch.topk`` promises no order
    among equal values, so its k + 1 smallest are re-sorted by (value,
    index), and rows whose k-th and (k+1)-th values tie -- where the
    choice among equal values decides the set -- take a full stable
    sort."""
    L = x.shape[-1]
    k1 = min(k + 1, L)
    v, i = torch.topk(x, k1, dim=-1, largest=False, sorted=True)
    o = torch.argsort(i, dim=-1)
    v, i = v.gather(-1, o), i.gather(-1, o)
    o = torch.argsort(v, dim=-1, stable=True)
    v, i = v.gather(-1, o), i.gather(-1, o)
    if k1 == k:
        return i
    i = i[..., :k].contiguous()
    tie = v[..., k - 1] == v[..., k]
    if bool(tie.any()):
        rows = torch.nonzero(tie.reshape(-1)).squeeze(1)
        full = torch.argsort(x.reshape(-1, L)[rows], dim=-1, stable=True)
        i.view(-1, k)[rows] = full[:, :k]
    return i


def pair_counts(gi: torch.Tensor, gj: torch.Tensor, mask: torch.Tensor,
                key: Optional[torch.Tensor] = None):
    """The distinct (key, i, j) triples among the masked index pairs, in
    lexicographic order, and how often each occurs: (key or None, i, j,
    counts) int64 tensors on the inputs' device.  ``key`` (the structure
    of each pair in a segmented batch) sorts before i and j, so each
    structure's pairs come out together in their own (i, j) order."""
    a, b = gi[mask].long(), gj[mask].long()
    k = None if key is None else key[mask].long()
    order = lexsort2(b, a)
    if k is not None:
        order = order[torch.argsort(k[order], stable=True)]
        k = k[order]
    a, b = a[order], b[order]
    first = torch.ones_like(a, dtype=torch.bool)
    first[1:] = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
    if k is not None:
        first[1:] |= k[1:] != k[:-1]
    starts = torch.nonzero(first).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_tensor([a.shape[0]])])
    return (None if k is None else k[starts], a[starts], b[starts],
            ends - starts)


def renumber_segments(key: torch.Tensor, size: torch.Tensor,
                      tie: torch.Tensor, eligible: torch.Tensor,
                      nseg: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The by-size renumbering of groups that each belong to one segment
    (a structure of a segmented batch): the ``eligible`` items ranked by
    (``key``, decreasing ``size``, increasing ``tie``).  Returns (gid,
    local, counts): per item its 1-based rank over all segments and
    within its own (0 when not eligible), and the (nseg,) eligible count
    of each segment.  Within a segment this is ``renumber_by_size``'s
    order, ties by the lower ``tie``."""
    idx = torch.nonzero(eligible).squeeze(1)
    o = torch.argsort(tie[idx], stable=True)
    o = o[torch.argsort(-size[idx][o], stable=True)]
    o = o[torch.argsort(key[idx][o], stable=True)]
    sel = idx[o]
    ksel = key[sel].long()
    counts = torch.bincount(ksel, minlength=nseg)
    rank = torch.arange(sel.shape[0], device=key.device)
    gid = torch.zeros(key.shape[0], dtype=torch.int64, device=key.device)
    gid[sel] = rank + 1
    local = torch.zeros_like(gid)
    local[sel] = rank - (torch.cumsum(counts, 0) - counts)[ksel] + 1
    return gid, local, counts


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
