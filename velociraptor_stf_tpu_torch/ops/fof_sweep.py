"""FOF on the cell-sorted sweep: context, coverage windows, label fixed
point and renumbering (port of velociraptor_stf_tpu/ops/pallas_fof.py).

Particles -- plus periodic ghost images -- are sorted on their (cx, r)
cell pair, r = cy*nz + cz.  Every neighbour of a slot then lies, for each
(dx, dy) stencil offset, in one contiguous slot range: the cells
(cx+dx, cy+dy, cz-1..cz+1) of one z-column.  Two indexes serve the kernels
of ``kernels/fof_sweep.py``, which evaluate the exact link criterion over
them (a candidate superset plus an exact test gives exact FOF links):

* ``column_index``: per slot its z-column ``cx*ny + cy`` and per z-column
  its first slot (``nx*ny + 1`` starts, a few MB where a per-cell table of
  the full context would take a GB).  ``detect`` takes it on the full
  context: a row finds the cells cz-1..cz+1 of its nine z-columns by a
  search inside each column's range.
* ``cell_windows``: per occupied cell, the nine z-column ranges of its own
  27 cells, disjoint by construction.  The sweeps take them on the
  subsets their fixed points sweep: a row scans exactly the slots of its
  27 cells, many times over.

A context builds each index at its first use and keeps it, so the full
context builds only the column index, a subset that a fixed point sweeps
only cell windows, each once.

Periodic boxes get ghost images of the particles within ``reach`` of a face
(three axis passes, so corners compose), which makes the grid
non-periodic.  Ghost slots mirror their source's label before each sweep
and fold their neighbour minimum back into the source after it.

The label fixed point (``_fixpoint``) is sweep -> ghost fold -> hook ->
pointer jumps, until a round changes nothing.  Labels only decrease and
every label is the slot of a member of the same component, so the result
is each component's lowest slot whatever the jump schedule; the exit is
jump-validated (a hook-stable state can still hold unmerged label chains).

Shapes are exact: ghost and subset arrays are sized from counts, so no
capacity can overflow and no fallback pipeline is needed.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..kernels import fof_sweep as K
from ..kernels._common import BIG_I32
from .cells import CellGrid, build_grid, cell_coords, limit_columns

# z-columns (nx * ny) a context may have for each slot (``build_fof_ctx``)
MAX_COLUMNS_PER_SLOT = 4


@dataclass
class FofCtx:
    """Cell-sorted slots (particles and ghost images) of one FOF problem."""

    pos: torch.Tensor        # (3, ns) float32 positions (ghosts shifted)
    cx: torch.Tensor         # (ns,) int64 x cell
    cr: torch.Tensor         # (ns,) int64 cy*nz + cz
    src: torch.Tensor        # (ns,) int64 original particle index
    is_real: torch.Tensor    # (ns,) bool, False for a ghost
    real_slot: torch.Tensor  # (n,) int64 slot of each original particle
    gslots: torch.Tensor     # (ng,) int64 ghost slots
    grs: torch.Tensor        # (ng,) int64 slot of each ghost's source
    n: int                   # original particle count
    ncells: Tuple[int, int, int]   # the cell grid's (nx, ny, nz)

    @property
    def ns(self) -> int:
        return int(self.src.shape[0])

    @cached_property
    def detect_index(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(col, colstart) of ``column_index``."""
        return column_index(self.cx, self.cr, self.ncells)

    @cached_property
    def sweep_windows(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cell, win) of ``cell_windows``."""
        return cell_windows(self.cx, self.cr, self.ncells)


def _ghost_pass(pos: torch.Tensor, src: torch.Tensor, axis: int,
                boxsize: float, reach: float):
    """Append an image, shifted by +-boxsize along ``axis``, of every slot
    within ``reach`` of either face."""
    x = pos[:, axis]
    lo = x < reach
    idx = torch.nonzero(lo | (x >= boxsize - reach)).squeeze(1)
    ghost = pos[idx]
    shift = torch.where(lo[idx], boxsize, -boxsize).to(pos.dtype)
    ghost[:, axis] = ghost[:, axis] + shift
    return torch.cat([pos, ghost]), torch.cat([src, src[idx]])


def column_index(cx: torch.Tensor, cr: torch.Tensor,
                 ncells: Tuple[int, int, int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(col, colstart): the (ns,) int32 z-column ``cx*ny + cy`` of each
    cell-sorted slot and the (nx*ny + 1,) int32 first slot of each
    z-column, so that column c holds the slots
    [colstart[c], colstart[c + 1]), sorted on their z cell; an empty
    column has an empty range.  One binary search per column over the
    sorted slots."""
    nx, ny, nz = ncells
    if nx * ny >= BIG_I32:
        raise ValueError(f"{nx * ny} z-columns exceed the int32 index")
    col = cx * ny + torch.div(cr, nz, rounding_mode="floor")
    colstart = torch.searchsorted(
        col, torch.arange(nx * ny + 1, device=cx.device), out_int32=True)
    return col.to(torch.int32), colstart


def cell_windows(cx: torch.Tensor, cr: torch.Tensor,
                 ncells: Tuple[int, int, int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cell, win): the (ns,) int32 number of each slot's cell among the
    occupied cells, in slot order, and (ncell, 9, 2) int32 windows
    (start, count) of each occupied cell (x, y, z): for each (dx, dy) in
    {-1, 0, 1}^2 the slots of cells (x+dx, y+dy, z-1..z+1).

    The z range is clamped to [0, nz) inside its z-column and a z-column
    off the grid is empty, so a window never reaches into the next
    z-column; the nine lie in nine z-columns and are disjoint.  Together
    they hold exactly the slots of the 27 cells around the cell.  In key
    space the cells (x+dx, y+dy, z') are the cell's own key plus
    (dx*ny + dy)*nz + z' - z, so each window is two binary searches of
    shifted keys over the sorted slot keys."""
    nx, ny, nz = ncells
    key = cx * (ny * nz) + cr
    cells, cell = torch.unique_consecutive(key, return_inverse=True)
    x, y, z = cells // (ny * nz), cells // nz % ny, cells % nz
    first = cells - (z > 0).long()                  # (x, y, max(z-1, 0))
    last = cells + (z < nz - 1).long()              # (x, y, min(z+1, nz-1))
    inside_x = {-1: x > 0, 0: None, 1: x < nx - 1}
    inside_y = {-1: y > 0, 0: None, 1: y < ny - 1}
    start = torch.empty(9, cells.shape[0], dtype=torch.int32,
                        device=cx.device)
    end = torch.empty_like(start)
    for k, (dx, dy) in enumerate((dx, dy) for dx in (-1, 0, 1)
                                 for dy in (-1, 0, 1)):
        shift = (dx * ny + dy) * nz
        torch.searchsorted(key, first + shift, out_int32=True, out=start[k])
        torch.searchsorted(key, last + shift, right=True, out_int32=True,
                           out=end[k])
        for inside in (inside_x[dx], inside_y[dy]):
            if inside is not None:              # z-column off the grid
                start[k].mul_(inside)
                end[k].mul_(inside)
    win = torch.stack([start, end - start], -1).transpose(0, 1)
    return cell.to(torch.int32), win.contiguous()


def _ctx_from_sorted(pos_s: torch.Tensor, cx: torch.Tensor, cr: torch.Tensor,
                     src: torch.Tensor, is_real: torch.Tensor, n: int,
                     ncells: Tuple[int, int, int]) -> FofCtx:
    slots = torch.arange(src.shape[0], device=src.device)
    real_slot = torch.zeros(n, dtype=torch.int64, device=src.device)
    real_slot[src[is_real]] = slots[is_real]
    gslots = torch.nonzero(~is_real).squeeze(1)
    return FofCtx(pos=pos_s.contiguous(), cx=cx, cr=cr, src=src,
                  is_real=is_real, real_slot=real_slot, gslots=gslots,
                  grs=real_slot[src[gslots]], n=n, ncells=ncells)


def build_fof_ctx(pos: torch.Tensor, boxsize: Optional[float],
                  reach: float) -> Tuple[FofCtx, CellGrid]:
    """Ghost images and cell sort of (N, 3) float32 positions.
    ``reach`` must be >= every linking length later swept on the ctx."""
    n = pos.shape[0]
    src = torch.arange(n, device=pos.device)
    periodic = boxsize is not None and boxsize > 0
    if periodic:
        for axis in range(3):
            pos, src = _ghost_pass(pos, src, axis, float(boxsize),
                                   float(reach))
        lo = np.full(3, -reach)
        hi = np.full(3, boxsize + reach)
    else:
        lo = pos.min(0).values.cpu().numpy()
        hi = pos.max(0).values.cpu().numpy()
    # z-columns beyond a few per slot only come from a very uneven open
    # domain; wider cells there keep the column index far under the slots
    # (and inside its int32 numbering)
    grid = limit_columns(build_grid(lo, hi, reach),
                         min(MAX_COLUMNS_PER_SLOT * int(pos.shape[0]),
                             BIG_I32 - 1))
    _, ny, nz = grid.ncells
    c = cell_coords(pos, grid)
    cr = c[:, 1] * nz + c[:, 2]
    order = torch.argsort(c[:, 0] * (ny * nz) + cr, stable=True)
    return _ctx_from_sorted(pos[order].T, c[order, 0], cr[order], src[order],
                            order < n, n, grid.ncells), grid


def _fixpoint(sweep_fn: Callable[[torch.Tensor], torch.Tensor],
              gslots: torch.Tensor, grs: torch.Tensor,
              labels0: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Min-label fixed point over slots; ``sweep_fn(labels) -> nm`` gives
    each slot's minimum label over itself and its links.  Returns (fully
    compressed labels, sweeps); one host sync per round.

    Every round ends with two pointer jumps, and the loop exits only when
    the round left the labels unchanged.  Labels never increase and each
    points at a real slot no later than its own, so an unchanged round
    means hook-stable AND l == l[l] (chain-free), which over a symmetric
    link relation is one label per connected component -- a hook-only test
    would accept chains such as 5->4->0 and 3->1 over links (0,4),(4,5),
    (5,3),(3,1)."""
    labels = labels0.clone()
    sweeps = 0
    while True:
        labels[gslots] = labels[grs]            # ghosts mirror their source
        nm = sweep_fn(labels).long()
        sweeps += 1
        nm.scatter_reduce_(0, grs, nm[gslots], "amin")   # fold ghosts back
        x = labels.scatter_reduce(0, labels, nm, "amin")  # hook
        x = x[x]
        x = x[x]
        if torch.equal(x, labels):
            break
        labels = x
    while not torch.equal(labels, labels[labels]):
        labels = labels[labels[labels]]
    return labels, sweeps


def renumber_roots(lab: torch.Tensor, src: torch.Tensor, nroots: int,
                   min_size: int) -> Tuple[torch.Tensor, int]:
    """(gid, ng): the group id of each element from its root label
    ``lab`` (< ``nroots``): ids 1..ng by decreasing size, equal sizes by
    the lowest ``src`` (original index) among their members, 0 below
    ``min_size`` (reference ``renumber_by_size`` / ``_renumber_masked``)."""
    sizes = torch.bincount(lab, minlength=nroots)
    min_id = torch.full((nroots,), BIG_I32, dtype=torch.int64,
                        device=lab.device).scatter_reduce_(0, lab, src,
                                                           "amin")
    roots = torch.nonzero(sizes >= max(min_size, 1)).squeeze(1)
    order = torch.argsort(min_id[roots], stable=True)
    order = order[torch.argsort(-sizes[roots][order], stable=True)]
    ng = int(roots.shape[0])
    gid_of_root = torch.zeros(nroots, dtype=torch.int64, device=lab.device)
    gid_of_root[roots[order]] = torch.arange(1, ng + 1, device=lab.device)
    return gid_of_root[lab], ng


def _renumber(labels: torch.Tensor, ctx: FofCtx, min_size: int
              ) -> Tuple[torch.Tensor, int]:
    """pfof in original order from the labels of the real slots."""
    real = torch.nonzero(ctx.is_real).squeeze(1)
    src = ctx.src[real]
    gid, ng = renumber_roots(labels[real], src, ctx.ns, min_size)
    pfof = torch.zeros(ctx.n, dtype=torch.int64, device=src.device)
    pfof[src] = gid
    return pfof, ng


class SweepFof:
    """Per-snapshot FOF context: build once, sweep the 3D and 6D criteria
    (reference ``PallasFof``, pallas_fof.py:1042)."""

    def __init__(self, pos: torch.Tensor, vel: torch.Tensor,
                 boxsize: Optional[float], reach: float):
        self.vel = vel
        self.ctx, _ = build_fof_ctx(pos, boxsize, reach)

    def subset(self, keep_orig: torch.Tensor) -> "SweepFof":
        """The slots whose original particle is in ``keep_orig`` (ghosts
        follow their source), in cell-sort order.  Exact for a criterion
        that can only link kept particles."""
        c = self.ctx
        idx = torch.nonzero(keep_orig[c.src]).squeeze(1)
        sub = object.__new__(SweepFof)
        sub.vel = self.vel
        sub.ctx = _ctx_from_sorted(c.pos[:, idx], c.cx[idx], c.cr[idx],
                                   c.src[idx], c.is_real[idx], c.n,
                                   c.ncells)
        return sub

    def linked_mask(self, linking_length: float) -> Tuple[torch.Tensor, int]:
        """(keep, nkeep): particles with a neighbour within the linking
        length (any image counts -- ghost rows fold into their source)."""
        c = self.ctx
        _, ny, nz = c.ncells
        col, colstart = c.detect_index
        pts = K.pack(c.pos.T, (c.cr % nz).int())
        cnt = K.detect(pts, col, colstart, ny, float(linking_length) ** 2)
        keep = torch.zeros(c.n, dtype=torch.bool, device=cnt.device)
        keep[c.src[cnt >= 2]] = True
        return keep, int(keep.sum())

    def fof3d(self, linking_length: float, min_size: int
              ) -> Tuple[torch.Tensor, int]:
        c = self.ctx
        b2 = float(linking_length) ** 2
        cell, win = c.sweep_windows
        pts = K.pack(c.pos.T)
        labels, _ = _fixpoint(
            lambda l: K.sweep3d(pts, l.int(), cell, win, b2),
            c.gslots, c.grs, torch.arange(c.ns, device=c.src.device))
        return _renumber(labels, c, min_size)

    def fof6d(self, ell6d: float, groups_orig: torch.Tensor,
              vscale2_orig: torch.Tensor, min_size: int
              ) -> Tuple[torch.Tensor, int]:
        """6DFOF within nonzero ``groups_orig`` (original order) with the
        per-particle velocity scale ``vscale2_orig``."""
        c = self.ctx
        cell, win = c.sweep_windows
        pts = K.pack(c.pos.T, groups_orig[c.src].int())
        rivs = 1.0 / torch.clamp_min(vscale2_orig[c.src].float(), 1e-30)
        vels = K.pack(self.vel[c.src].float(), rivs)
        inv_b2 = 1.0 / float(ell6d) ** 2
        labels, _ = _fixpoint(
            lambda l: K.sweep6d(pts, vels, l.int(), cell, win, inv_b2),
            c.gslots, c.grs, torch.arange(c.ns, device=c.src.device))
        return _renumber(labels, c, min_size)
