"""Pair (edge) pipeline: candidate pairs from a cell grid, pair predicates,
components of an edge list, renumbering, attachment and nearest assignment
(port of velociraptor_stf_tpu/ops/fof.py: ``build_edges``, ``FlatEdges``,
the ``Pred*`` criteria, ``refine_edge_mask``, ``fof_labels_from_edges``,
``renumber_by_size``, ``attach_rounds``, ``nearest_assign_edges`` and
``fof3d``).

Points are sorted by the cell of a grid at least one linking length wide
(periodic when the box is), so every candidate of a row lies in the 27
cells around its own: per occupied row cell, 18 windows into the sorted
column points (nine z-runs and nine periodic z-wrap cells,
``ops/so.py::point_windows_dense``).  ``kernels/_common.py::cell_pairs``
expands the windows into flat (row, column) pairs in batches of whole rows
under a fixed budget; each batch is tested (``build_edges``) or reduced
(``nearest_assign_points``) before the next is formed, so no N x window
array exists.  Squared separations come from coordinate differences, the
minimum image in a periodic box, summed x, y, z in order, as the
reference's ``_pair_d2_bcast`` rounds them.

``segmented_cells`` sorts many disjoint point sets at once, each on its
own grid, keyed by (set, cell), so one expansion serves a batch of sets
without a pair between two of them (the recursion's batched subset
search).

The reference's dense and half prefix tables, slab windows, fused builders
and power-of-two pads served its fixed shapes and are not carried over;
shapes here are exact.  Index tensors are int64; group ids are returned as
int32, as the reference returns them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels._common import BIG_I32, cell_pairs
from . import segments as seg
from .cells import (CellGrid, bin_particles, bin_segments, build_grid,
                    unpack_cells)
from .fof_sweep import _fixpoint, renumber_roots
from .so import point_windows_dense

Fields = Dict[str, torch.Tensor]
PairPredicate = Callable[[torch.Tensor, Fields, Fields], torch.Tensor]


def pair_d2(own_pos: torch.Tensor, nbr_pos: torch.Tensor,
            boxsize: Optional[float]) -> torch.Tensor:
    """Squared distances of (..., 3) position pairs, the minimum image in
    a periodic box (``torch.round`` rounds half to even, as
    ``jnp.round``)."""
    d = own_pos - nbr_pos
    if boxsize:
        d = d - boxsize * torch.round(d / boxsize)
    return seg.sq3(d)


# ---------------------------------------------------------------------------
# Pair criteria (reference fofalgo.h / NBodylib FOF3d/FOF6d)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Pred3D:
    """Plain 3DFOF: separation within the linking length."""

    symmetric = True

    b2: float

    def __call__(self, d2, own, nbr):
        return d2 <= self.b2


@dataclasses.dataclass(frozen=True)
class Pred3DTypes:
    """FOF3dDM (fofalgo.cxx): both particles must be of the given type for
    a link (baryons may not form links; used when iBaryonSearch > 1)."""

    symmetric = True

    b2: float
    dark_type: int = 1

    def __call__(self, d2, own, nbr):
        ok = (own["ptype"] == self.dark_type) & \
            (nbr["ptype"] == self.dark_type)
        return (d2 <= self.b2) & ok


@dataclasses.dataclass(frozen=True)
class Pred6D:
    """FOF6d: dx^2/ellx^2 + dv^2/ellv^2 <= 1, optionally only for pairs
    of one parent (3DFOF) group (reference search.cxx:552-576)."""

    symmetric = True

    b2: float
    v2: float
    same_group: bool = True

    def __call__(self, d2, own, nbr):
        dv2 = seg.sq3(own["vel"] - nbr["vel"])
        ok = d2 / self.b2 + dv2 / self.v2 <= 1.0
        if self.same_group:
            ok = ok & (own["group"] == nbr["group"])
        return ok


@dataclasses.dataclass(frozen=True)
class Pred6DScaled:
    """6DFOF on pre-scaled phase coordinates (unit ball), the velocity
    scale a per-particle field (adaptive variant)."""

    symmetric = True

    same_group: bool = True

    def __call__(self, d2, own, nbr):
        dv2 = seg.sq3(own["vel"] - nbr["vel"])
        ok = d2 + dv2 / own["vscale2"] <= 1.0
        if self.same_group:
            ok = ok & (own["group"] == nbr["group"])
        return ok


def make_pred_3d(b2: float) -> PairPredicate:
    return Pred3D(float(b2))


def make_pred_3d_types(b2: float, dark_type: int = 1) -> PairPredicate:
    return Pred3DTypes(float(b2), dark_type)


def make_pred_6d(b2: float, v2: float,
                 same_group: bool = True) -> PairPredicate:
    return Pred6D(float(b2), float(v2), same_group)


def make_pred_6d_scaled(same_group: bool = True) -> PairPredicate:
    return Pred6DScaled(same_group)


# ---------------------------------------------------------------------------
# Candidate pairs from the cell grid
# ---------------------------------------------------------------------------

def pair_grid(points: Sequence[torch.Tensor], cellwidth: float,
              boxsize: Optional[float],
              bounds: Optional[Tuple[np.ndarray, np.ndarray]] = None
              ) -> CellGrid:
    """Cells at least ``cellwidth`` wide over the periodic box, or over
    ``bounds`` (default: the extent of the ``points`` tensors)."""
    if boxsize:
        return build_grid(np.zeros(3), np.full(3, boxsize), cellwidth,
                          periodic=True, boxsize=float(boxsize))
    if bounds is None:
        held = [p for p in points if p.shape[0]]
        bounds = (np.min([p.amin(0).cpu().numpy() for p in held], 0),
                  np.max([p.amax(0).cpu().numpy() for p in held], 0)) \
            if held else (np.zeros(3), np.ones(3))
    return build_grid(np.asarray(bounds[0], np.float64),
                      np.asarray(bounds[1], np.float64), cellwidth)


def stencil_windows(row_cid_sorted: torch.Tensor,
                    col_cid_sorted: torch.Tensor, grid: CellGrid,
                    periodic: bool, clip_x: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cell, win) for ``cell_pairs``: the (nrows,) number of each
    cell-sorted row's cell among the occupied row cells, and per such cell
    the (ncell, 18, 2) int32 windows (start, count) into the cell-sorted
    columns that hold the 27 cells around it (``clip_x``: periodic in y
    and z only)."""
    cells, cell = torch.unique_consecutive(row_cid_sorted,
                                           return_inverse=True)
    pst, pcn = point_windows_dense(unpack_cells(cells, grid), col_cid_sorted,
                                   grid, periodic, clip_x)
    return cell, torch.stack([pst, pcn], -1).to(torch.int32)


def _gather(fields: Fields, idx: torch.Tensor) -> Fields:
    """The fields' rows ``idx``; a 0-d field is shared by every row."""
    return {k: v if v.dim() == 0 else v[idx] for k, v in fields.items()}


@dataclasses.dataclass
class FlatEdges:
    """Edge list between cell-sorted particles under a pair criterion,
    built once per search and reused by label fixed points, attachment
    rounds and nearest-assignment passes.  ``undirected``: each pair
    appears once, so a label fixed point must sweep both ways."""

    erow: torch.Tensor        # (E,) int64 sorted-particle index
    ecol: torch.Tensor        # (E,) int64
    n: int                    # particle count
    order: torch.Tensor       # (n,) sorted -> original index
    pos_s: torch.Tensor       # (n, 3) sorted positions
    fields_s: Fields          # sorted per-particle fields
    boxsize: Optional[float]  # the periodic box, None when open
    undirected: bool = False


def build_edges(pos: torch.Tensor, linking_length: float,
                boxsize: Optional[float] = None,
                fields: Optional[Fields] = None,
                predicate: Optional[PairPredicate] = None,
                bounds: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                half: Optional[bool] = None) -> FlatEdges:
    """Cell sort + candidate pairs + criterion -> compacted edge list in
    (row, window, column) order of the cell-sorted particles.  Self pairs
    are kept in the directed form (no-ops for min propagation).

    ``half``: keep each pair once (column after row), which is exact for
    a symmetric criterion; default: on when the criterion says it is
    (``symmetric = True``)."""
    n = pos.shape[0]
    box = float(boxsize) if boxsize else None
    if predicate is None:
        predicate = Pred3D(float(linking_length) ** 2)
    if half is None:
        half = bool(getattr(predicate, "symmetric", False))
    grid = pair_grid([pos], linking_length, box, bounds)
    order, cid = bin_particles(pos, grid, periodic=box is not None)
    pos_s = pos[order]
    fields_s = _gather(fields or {}, order)
    cell, win = stencil_windows(cid, cid, grid, box is not None)
    erows, ecols = [], []
    for row, col in cell_pairs(cell, win):
        if half:
            fwd = col > row
            row, col = row[fwd], col[fwd]
        ok = predicate(pair_d2(pos_s[row], pos_s[col], box),
                       _gather(fields_s, row), _gather(fields_s, col))
        erows.append(row[ok])
        ecols.append(col[ok])
    empty = torch.zeros(0, dtype=torch.int64, device=pos.device)
    return FlatEdges(torch.cat(erows) if erows else empty,
                     torch.cat(ecols) if ecols else empty, n, order, pos_s,
                     fields_s, box, undirected=half)


@dataclasses.dataclass
class SegmentedCells:
    """Many disjoint point sets (segments) in one cell sort: the rows of
    segment s are rows ``starts[s]:starts[s + 1]`` both before and after
    the sort, and within a segment the sorted order, windows and pairs are
    those ``build_edges`` gives on that segment alone over its own
    ``bounds`` (``cells.bin_segments``).  No window reaches across
    segments, so no pair joins two of them."""

    order: torch.Tensor       # (n,) sorted -> original row
    seg: torch.Tensor         # (n,) int64 segment of each row (either order)
    pos_s: torch.Tensor       # (n, 3) sorted positions
    cell: torch.Tensor        # (n,) int64 occupied cell of each sorted row
    win: torch.Tensor         # (ncell, 9, 2) int32 windows into sorted rows
    starts: np.ndarray        # (nseg + 1,) host first row of each segment

    def candidates(self) -> torch.Tensor:
        """(nseg,) int64 candidate slots per segment: every (row, column)
        of the rows' windows, the slots ``build_edges`` expands."""
        per_row = self.win[:, :, 1].long().sum(1)[self.cell]
        cum = torch.cat([per_row.new_zeros(1), torch.cumsum(per_row, 0)])
        ends = torch.from_numpy(self.starts).to(cum.device)
        return cum[ends[1:]] - cum[ends[:-1]]

    def pairs(self, r0: int, r1: int, reach: Optional[float],
              b2: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(erow, ecol, d2): each pair of the sorted rows [r0, r1) within
        ``reach`` once (column after row, as ``build_edges``' each-pair-
        once form), indices relative to r0, open-boundary separations.
        ``b2``: the squared reach as ``Pred3D`` takes it (default
        reach * reach); ``reach`` None: every candidate of the windows,
        as ``build_edges`` hands them to a criterion.  [r0, r1) must hold
        whole segments."""
        pred = None if reach is None else \
            Pred3D(reach * reach if b2 is None else b2)
        rows, cols, d2s = [], [], []
        for row, col in cell_pairs(self.cell[r0:r1], self.win):
            row = row + r0
            fwd = col > row
            row, col = row[fwd], col[fwd]
            d2 = pair_d2(self.pos_s[row], self.pos_s[col], None)
            if pred is not None:
                ok = pred(d2, {}, {})
                row, col, d2 = row[ok], col[ok], d2[ok]
            rows.append(row - r0)
            cols.append(col - r0)
            d2s.append(d2)
        if not rows:
            e = torch.zeros(0, dtype=torch.int64, device=self.pos_s.device)
            return e, e, self.pos_s.new_zeros(0)
        return torch.cat(rows), torch.cat(cols), torch.cat(d2s)


def segmented_cells(pos: torch.Tensor, counts: Sequence[int],
                    bounds: Sequence[Tuple[np.ndarray, np.ndarray]],
                    cellwidth: float) -> SegmentedCells:
    """One cell sort of consecutive point sets of ``counts`` rows each,
    set s over its own open grid of cells at least ``cellwidth`` wide on
    ``bounds[s]`` (host (lo, hi)), with the 27-cell windows of every
    occupied cell."""
    dev = pos.device
    counts = np.asarray(counts, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)])
    seg = torch.repeat_interleave(
        torch.arange(len(counts), device=dev),
        torch.from_numpy(counts).to(dev), output_size=int(starts[-1]))
    grids = [pair_grid([], cellwidth, None, b) for b in bounds]
    order, cid, joint = bin_segments(pos, seg, grids)
    cell, win = stencil_windows(cid, cid, joint, False)
    # open grids: the nine periodic z-wrap windows are empty
    return SegmentedCells(order, seg, pos[order], cell,
                          win[:, :9].contiguous(), starts)


def refine_edge_mask(pos_s: torch.Tensor, fields_s: Fields,
                     erow: torch.Tensor, ecol: torch.Tensor,
                     boxsize: Optional[float],
                     predicate: PairPredicate) -> torch.Tensor:
    """A (tighter) pair criterion evaluated along an existing edge list.
    Valid when the new criterion implies the old one spatially (6DFOF
    with ell6d <= ell3d: every 6D pair is already a 3D edge, reference
    search.cxx:552-576)."""
    return predicate(pair_d2(pos_s[erow], pos_s[ecol], boxsize),
                     _gather(fields_s, erow), _gather(fields_s, ecol))


# ---------------------------------------------------------------------------
# Components, renumbering
# ---------------------------------------------------------------------------

def fof_labels_from_edges(erow: torch.Tensor, ecol: torch.Tensor, n: int,
                          undirected: bool = False,
                          with_sweeps: bool = False):
    """(n,) int64 label of each particle's component over the edge list:
    the lowest index of the component.  The fixed point is that of the
    sweep path (sweep, hook, pointer jumps, jump-validated exit);
    ``undirected`` lists are swept both ways.  ``with_sweeps``: also
    return the sweeps it took (one host sync each)."""
    if undirected:
        erow, ecol = torch.cat([erow, ecol]), torch.cat([ecol, erow])
    none = torch.zeros(0, dtype=torch.int64, device=erow.device)
    labels, sweeps = _fixpoint(
        lambda l: l.scatter_reduce(0, erow, l[ecol], "amin"), none, none,
        torch.arange(n, device=erow.device))
    return (labels, sweeps) if with_sweeps else labels


def renumber_by_size(labels: torch.Tensor, min_size: int,
                     orig_index: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, int]:
    """Root labels -> (pfof int32 in the order of ``labels``, ngroups):
    ids 1..ngroups by decreasing size, equal sizes by the smaller lowest
    ``orig_index`` of their members, 0 below ``min_size`` (reference
    ``ReorderGroupIDs`` semantics)."""
    n = labels.shape[0]
    if orig_index is None:
        orig_index = torch.arange(n, device=labels.device)
    gid, ng = renumber_roots(labels.long(), orig_index.long(), n, min_size)
    return gid.to(torch.int32), ng


def fof3d(pos: torch.Tensor, linking_length: float,
          boxsize: Optional[float] = None, min_size: int = 8,
          vel: Optional[torch.Tensor] = None,
          extra_fields: Optional[Fields] = None,
          predicate: Optional[PairPredicate] = None,
          return_order: bool = False,
          bounds: Optional[Tuple[np.ndarray, np.ndarray]] = None):
    """3DFOF over positions, or FOF under ``predicate`` (which sees
    ``vel`` and ``extra_fields``): (pfof, ngroups) with int32 pfof in the
    original particle order, ids 1..ngroups by decreasing size, 0 =
    untagged (reference SearchFullSet's 3DFOF stage, search.cxx:24-213)."""
    fields = dict(extra_fields or {})
    if vel is not None:
        fields["vel"] = vel
    edges = build_edges(pos, linking_length, boxsize=boxsize, fields=fields,
                        predicate=predicate, bounds=bounds)
    labels = fof_labels_from_edges(edges.erow, edges.ecol, edges.n,
                                   undirected=edges.undirected)
    pfof_s, ng = renumber_by_size(labels, min_size, orig_index=edges.order)
    pfof = torch.zeros_like(pfof_s)
    pfof[edges.order] = pfof_s
    if return_order:
        return pfof, ng, edges.order
    return pfof, ng


# ---------------------------------------------------------------------------
# Attachment and nearest assignment
# ---------------------------------------------------------------------------

def attach_rounds(labels: torch.Tensor, erow: torch.Tensor,
                  ecol: torch.Tensor, nrounds: int) -> torch.Tensor:
    """Untagged particles (label 0) adopt the lowest group id among their
    linked tagged neighbours, round by round until none changes or
    ``nrounds`` (reference FOFStreamwithprobIterative, fofalgo.cxx:36-50:
    the edges hold the geometric criterion, the tagged gate varies)."""
    big = torch.iinfo(labels.dtype).max
    for _ in range(nrounds):
        lc = labels[ecol]
        nmin = torch.full_like(labels, big).scatter_reduce_(
            0, erow, torch.where(lc > 0, lc, big), "amin")
        new = torch.where((labels == 0) & (nmin != big), nmin, labels)
        if torch.equal(new, labels):
            break
        labels = new
    return labels


def _nearest_reduce(nrows: int, rows: torch.Tensor, dist: torch.Tensor,
                    g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row the lowest distance over its candidates and the lowest
    group id among the candidates at that distance: ((nrows,) distance,
    +inf without a candidate; (nrows,) int64 group, BIG_I32 without).
    Two order-independent minima, so the result is the same on every
    run."""
    dmin = torch.full((nrows,), math.inf, dtype=dist.dtype,
                      device=dist.device).scatter_reduce_(0, rows, dist,
                                                          "amin")
    winner = torch.isfinite(dist) & (dist <= dmin[rows])
    gmin = torch.full((nrows,), BIG_I32, dtype=torch.int64,
                      device=dist.device).scatter_reduce_(
        0, rows, torch.where(winner, g, BIG_I32), "amin")
    return dmin, gmin


def nearest_assign_edges(groups_s: torch.Tensor, pos_s: torch.Tensor,
                         fields_s: Fields, erow: torch.Tensor,
                         ecol: torch.Tensor, boxsize: Optional[float],
                         metric) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each particle's group by its generalised-nearest tagged neighbour
    along the edge list.  ``metric(d2, own, nbr) -> (dist, eligible)`` per
    edge.  Returns (group int32, distance) per sorted particle, (0, +inf)
    without an eligible neighbour; equal distances go to the lowest group
    id (reference SearchBaryons, search.cxx:3201+)."""
    dist, elig = metric(pair_d2(pos_s[erow], pos_s[ecol], boxsize),
                        _gather(fields_s, erow), _gather(fields_s, ecol))
    g = groups_s[ecol].long()
    ok = elig & (g > 0) & (erow != ecol)
    dmin, gmin = _nearest_reduce(groups_s.shape[0], erow,
                                 torch.where(ok, dist, math.inf), g)
    return torch.where(gmin == BIG_I32, 0, gmin).to(torch.int32), dmin


def stencil_batches(pos_q: torch.Tensor, pos_c: torch.Tensor,
                    cellwidth: float, boxsize: Optional[float]
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Iterator[Tuple[torch.Tensor, torch.Tensor]]]:
    """Candidate pairs between two point sets: (order_q, order_c, batches)
    with the stable cell sorts of the query and the column points on one
    grid of cells at least ``cellwidth`` wide, and the batches of (row,
    col) pairs -- indices into the sorted sets, whole rows per batch --
    of each query's 27 cells."""
    box = float(boxsize) if boxsize else None
    grid = pair_grid([pos_q, pos_c], cellwidth, box)
    order_q, cid_q = bin_particles(pos_q, grid, periodic=box is not None)
    order_c, cid_c = bin_particles(pos_c, grid, periodic=box is not None)
    cell, win = stencil_windows(cid_q, cid_c, grid, box is not None)
    return order_q, order_c, cell_pairs(cell, win)


def nearest_assign_points(pos_q: torch.Tensor, fields_q: Fields,
                          pos_c: torch.Tensor, fields_c: Fields,
                          groups_c: torch.Tensor, cellwidth: float,
                          boxsize: Optional[float], metric
                          ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Each query point's group by its generalised-nearest column point
    (all tagged: ``groups_c`` > 0) among the 27 cells around it; the
    metric must reject every pair further apart than ``cellwidth``.
    Returns (group int32, distance, pairs enumerated) in the queries'
    order, (0, +inf) without an eligible column.

    The pair list is never whole: each batch of whole rows is gathered,
    measured and reduced to the rows' (distance, group) minima before the
    next is formed."""
    nq = pos_q.shape[0]
    box = float(boxsize) if boxsize else None
    order_q, order_c, batches = stencil_batches(pos_q, pos_c, cellwidth, box)
    pos_qs, fq = pos_q[order_q], _gather(fields_q, order_q)
    pos_cs, fc = pos_c[order_c], _gather(fields_c, order_c)
    g_cs = groups_c[order_c].long()
    dmin = torch.full((nq,), math.inf, dtype=pos_q.dtype,
                      device=pos_q.device)
    gmin = torch.full((nq,), BIG_I32, dtype=torch.int64,
                      device=pos_q.device)
    npairs = 0
    for row, col in batches:
        npairs += int(row.shape[0])
        dist, elig = metric(pair_d2(pos_qs[row], pos_cs[col], box),
                            _gather(fq, row), _gather(fc, col))
        d, g = _nearest_reduce(nq, row, torch.where(elig, dist, math.inf),
                               g_cs[col])
        # a batch holds whole rows: every other row of it is (+inf, BIG)
        dmin = torch.minimum(dmin, d)
        gmin = torch.minimum(gmin, g)
    grp = torch.zeros(nq, dtype=torch.int32, device=pos_q.device)
    grp[order_q] = torch.where(gmin == BIG_I32, 0, gmin).to(torch.int32)
    dout = torch.empty_like(dmin)
    dout[order_q] = dmin
    return grp, dout, npairs
