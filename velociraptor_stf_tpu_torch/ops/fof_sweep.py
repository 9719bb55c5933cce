"""FOF on the cell-sorted sweep: context, coverage windows, label fixed
point and renumbering (port of velociraptor_stf_tpu/ops/pallas_fof.py).

Particles -- plus periodic ghost images -- are sorted on their (cx, r)
cell pair, r = cy*nz + cz.  For a block of ``R_BLOCK`` consecutive slots
spanning cells (cx0, r0)..(cx1, r1), every neighbour of every row lies, for
each (dx, dy) stencil offset, in one contiguous slot range; the nine ranges
are merged into a disjoint union per block (``block_windows``), and the
kernels of ``kernels/fof_sweep.py`` evaluate the exact link criterion over
them: a candidate superset plus an exact test gives exact FOF links.

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
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..kernels import R_BLOCK
from ..kernels import fof_sweep as K
from ..kernels._common import BIG_I32
from .cells import CellGrid, build_grid, cell_coords

from velociraptor_stf_tpu.utils import telemetry


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
    windows: torch.Tensor    # (nblocks, 9, 2) int32 coverage windows
    n: int                   # original particle count

    @property
    def ns(self) -> int:
        return int(self.src.shape[0])


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


def _locate(key: torch.Tensor, stripe_start: torch.Tensor, qx: torch.Tensor,
            qr: torch.Tensor, nx: int, nynz: int, right: bool
            ) -> torch.Tensor:
    """Position of the cell pair (qx, qr) in the sorted slots, searched
    within stripe qx only (as the reference's per-stripe binary search):
    0 left of the grid, the end of real slots right of it."""
    qxc = qx.clamp(0, nx - 1)
    pos = torch.searchsorted(key, qxc * nynz + qr, right=right)
    pos = torch.minimum(torch.maximum(pos, stripe_start[qxc]),
                        stripe_start[qxc + 1])
    return torch.where(qx < 0, 0, torch.where(qx >= nx, stripe_start[nx],
                                              pos))


def block_windows(cx: torch.Tensor, cr: torch.Tensor,
                  ncells: Tuple[int, int, int], rows: int = R_BLOCK,
                  chunk: int = 1) -> torch.Tensor:
    """(nblocks, 9, 2) int32 disjoint coverage windows (start, count) of
    each block of ``rows`` cell-sorted slots, one per (dx, dy) offset
    before merging (reference ``_block_ranges``, pallas_fof.py:301).

    Window(dx, dy) = [locate(cx0+dx, r0 + dy*nz - 1),
                      locate(cx1+dx, r1 + dy*nz + 1)).  The windows of a
    block can overlap, and a column scanned twice would count twice in the
    detect pass, so they are merged into their disjoint union: sorted by
    start, each start clamped past the running covered end.

    The kernels take ``chunk=1`` (exact slots).  With the reference's chunk
    (CH = 1024) and rows (512) -- and its padded ``cx``/``cr`` -- this
    reproduces the reference's windows in chunk units bit for bit.
    Slots with ``cx == nx`` are padding and sort last."""
    device = cx.device
    ns = int(cx.shape[0])
    nx, ny, nz = ncells
    nynz = ny * nz
    nblocks = -(-ns // rows)
    key = cx * nynz + cr
    stripe_start = torch.searchsorted(
        cx, torch.arange(nx + 1, dtype=cx.dtype, device=device))
    first = torch.arange(nblocks, device=device) * rows
    last = torch.clamp(first + rows, max=ns) - 1
    x0, r0, x1, r1 = cx[first], cr[first], cx[last], cr[last]
    dxs = torch.tensor([-1, -1, -1, 0, 0, 0, 1, 1, 1],
                       device=device)[:, None]
    dys = torch.tensor([-1, 0, 1] * 3, device=device)[:, None]
    # normalise the mixed radix (|offset| < nynz: one borrow/carry)
    qr_lo = r0[None, :] + dys * nz - 1
    borrow = (qr_lo < 0).long()
    qx_lo = x0[None, :] + dxs - borrow
    qr_lo = qr_lo + borrow * nynz
    qr_hi = r1[None, :] + dys * nz + 1
    carry = (qr_hi >= nynz).long()
    qx_hi = x1[None, :] + dxs + carry
    qr_hi = qr_hi - carry * nynz
    s = _locate(key, stripe_start, qx_lo, qr_lo, nx, nynz, right=False)
    e = _locate(key, stripe_start, qx_hi, qr_hi, nx, nynz, right=True)
    nch_total = -(-ns // chunk)
    valid = (e > s) & (x0[None, :] < nx)
    c0 = torch.div(s, chunk, rounding_mode="floor")
    length = torch.where(valid, -torch.div(-e, chunk, rounding_mode="floor")
                         - c0, 0)
    start = torch.where(length > 0, c0, nch_total)   # empty windows last
    start, order = torch.sort(start, dim=0, stable=True)
    length = torch.gather(length, 0, order)
    run = start[0] + length[0]
    out = [torch.stack([start[0], length[0]], -1)]
    for w in range(1, 9):
        st = torch.maximum(start[w], run)
        ln = torch.clamp(start[w] + length[w] - st, min=0)
        out.append(torch.stack([st, ln], -1))
        run = torch.maximum(run, st + ln)
    return torch.stack(out, 1).to(torch.int32)       # (nblocks, 9, 2)


def _ctx_from_sorted(pos_s: torch.Tensor, cx: torch.Tensor, cr: torch.Tensor,
                     src: torch.Tensor, is_real: torch.Tensor, n: int,
                     grid: CellGrid) -> FofCtx:
    slots = torch.arange(src.shape[0], device=src.device)
    real_slot = torch.zeros(n, dtype=torch.int64, device=src.device)
    real_slot[src[is_real]] = slots[is_real]
    gslots = torch.nonzero(~is_real).squeeze(1)
    return FofCtx(pos=pos_s.contiguous(), cx=cx, cr=cr, src=src,
                  is_real=is_real, real_slot=real_slot, gslots=gslots,
                  grs=real_slot[src[gslots]],
                  windows=block_windows(cx, cr, grid.ncells), n=n)


def build_fof_ctx(pos: torch.Tensor, boxsize: Optional[float],
                  reach: float) -> Tuple[FofCtx, CellGrid]:
    """Ghost images, cell sort and windows for (N, 3) float32 positions.
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
    grid = build_grid(lo, hi, reach)
    _, ny, nz = grid.ncells
    c = cell_coords(pos, grid)
    cr = c[:, 1] * nz + c[:, 2]
    order = torch.argsort(c[:, 0] * (ny * nz) + cr, stable=True)
    return _ctx_from_sorted(pos[order].T, c[order, 0], cr[order], src[order],
                            order < n, n, grid), grid


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


def _renumber(labels: torch.Tensor, ctx: FofCtx, min_size: int
              ) -> Tuple[torch.Tensor, int]:
    """pfof in original order: ids 1..ng by decreasing size over real slots,
    ties by lowest original index, 0 below ``min_size`` (reference
    ``_renumber_masked``)."""
    real = torch.nonzero(ctx.is_real).squeeze(1)
    lab = labels[real]
    src = ctx.src[real]
    sizes = torch.bincount(lab, minlength=ctx.ns)
    min_id = torch.full((ctx.ns,), BIG_I32, dtype=torch.int64,
                        device=lab.device).scatter_reduce_(0, lab, src,
                                                           "amin")
    roots = torch.nonzero(sizes >= max(min_size, 1)).squeeze(1)
    order = torch.argsort(min_id[roots], stable=True)
    order = order[torch.argsort(-sizes[roots][order], stable=True)]
    ng = int(roots.shape[0])
    gid_of_root = torch.zeros(ctx.ns, dtype=torch.int64, device=lab.device)
    gid_of_root[roots[order]] = torch.arange(1, ng + 1, device=lab.device)
    pfof = torch.zeros(ctx.n, dtype=torch.int64, device=lab.device)
    pfof[src] = gid_of_root[lab]
    return pfof, ng


class SweepFof:
    """Per-snapshot FOF context: build once, sweep the 3D and 6D criteria
    (reference ``PallasFof``, pallas_fof.py:1042)."""

    def __init__(self, pos: torch.Tensor, vel: torch.Tensor,
                 boxsize: Optional[float], reach: float):
        self.vel = vel
        self.ctx, self.grid = build_fof_ctx(pos, boxsize, reach)

    def subset(self, keep_orig: torch.Tensor) -> "SweepFof":
        """The slots whose original particle is in ``keep_orig`` (ghosts
        follow their source), in cell-sort order.  Exact for a criterion
        that can only link kept particles."""
        c = self.ctx
        idx = torch.nonzero(keep_orig[c.src]).squeeze(1)
        sub = object.__new__(SweepFof)
        sub.vel, sub.grid = self.vel, self.grid
        sub.ctx = _ctx_from_sorted(c.pos[:, idx], c.cx[idx], c.cr[idx],
                                   c.src[idx], c.is_real[idx], c.n,
                                   self.grid)
        return sub

    def linked_mask(self, linking_length: float) -> Tuple[torch.Tensor, int]:
        """(keep, nkeep): particles with a neighbour within the linking
        length (any image counts -- ghost rows fold into their source)."""
        c = self.ctx
        cnt = K.detect(c.pos, c.windows, float(linking_length) ** 2)
        keep = torch.zeros(c.n, dtype=torch.bool, device=cnt.device)
        keep[c.src[cnt >= 2]] = True
        return keep, int(keep.sum())

    def fof3d(self, linking_length: float, min_size: int
              ) -> Tuple[torch.Tensor, int]:
        c = self.ctx
        b2 = float(linking_length) ** 2
        labels, sweeps = _fixpoint(
            lambda l: K.sweep3d(c.pos, l.int(), c.windows, b2),
            c.gslots, c.grs, torch.arange(c.ns, device=c.src.device))
        telemetry.count("fof3d_sweeps", sweeps)
        return _renumber(labels, c, min_size)

    def fof6d(self, ell6d: float, groups_orig: torch.Tensor,
              vscale2_orig: torch.Tensor, min_size: int
              ) -> Tuple[torch.Tensor, int]:
        """6DFOF within nonzero ``groups_orig`` (original order) with the
        per-particle velocity scale ``vscale2_orig``."""
        c = self.ctx
        grp = groups_orig[c.src].int().contiguous()
        rivs = 1.0 / torch.clamp_min(vscale2_orig[c.src].float(), 1e-30)
        vel = self.vel[c.src].T.contiguous().float()
        inv_b2 = 1.0 / float(ell6d) ** 2
        labels, sweeps = _fixpoint(
            lambda l: K.sweep6d(c.pos, vel, rivs, grp, l.int(), c.windows,
                                inv_b2),
            c.gslots, c.grs, torch.arange(c.ns, device=c.src.device))
        telemetry.count("fof6d_sweeps", sweeps)
        return _renumber(labels, c, min_size)
