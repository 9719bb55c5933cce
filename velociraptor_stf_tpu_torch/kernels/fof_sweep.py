"""FOF neighbour scans: wrappers of ``csrc/fof_sweep.cu`` and their plain
PyTorch versions.

All three take cell-sorted slots (``ops/fof_sweep.py``) as packed
(``pack``) (ns, 4) float32 rows: one 16-byte load per column.

* ``detect``  <- ``_detect_kernel_3d`` (ops/pallas_fof.py:613): per slot,
  the number of slots of its 27 cells with |dx|^2 <= b2, itself included.
  Rows are (x, y, z, z cell bits); it takes the column index
  (``ops/fof_sweep.py::column_index``): ``col`` (ns,) int32, the row's
  z-column cx*ny + cy, and ``colstart`` (nx*ny + 1,) int32, each
  z-column's first slot.  In each of the row's nine z-columns that lie on
  the grid it scans the slots of z cells cz-1..cz+1, found by a search
  inside the column's range (``column_windows``).
* ``sweep3d`` <- ``_sweep_kernel_3d`` (:578): per slot, the minimum label
  over its own and the candidates' with |dx|^2 <= b2.
* ``sweep6d`` <- ``_sweep_kernel_6d`` (:680): per slot, the minimum label
  over its own and the candidates' with d2*inv_b2 + dv2*rivs_row <= 1 in
  the same nonzero group.

The sweeps take each row's own cell windows (``ops/fof_sweep.py::
cell_windows``): ``cell`` (ns,) int32, the row's cell, and ``win``
(ncell, 9, 2) int32, each cell's nine (start, count) ranges of the slots
of its 27 cells.  Their rows are (x, y, z, .), for the 6D sweep
(x, y, z, group bits) and (vx, vy, vz, rivs).  A row whose cell has empty
windows keeps its label.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import LAUNCHES
from ._build import check, load_library
from ._common import (BIG_I32, cell_pairs, check_cells, check_columns, f32,
                      kernel_device, on_device, pair_d2, require, stream)

NWIN = 9


def pack(xyz: torch.Tensor, lane: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    """(ns, 4) float32 rows (x, y, z, lane) of (ns, 3) float32 ``xyz``: a
    float32 ``lane`` as it is, an int32 one as its bits, none as 0.  One
    16-byte load per column in the kernels."""
    out = torch.zeros(xyz.shape[0], 4, dtype=torch.float32,
                      device=xyz.device)
    out[:, :3] = xyz
    if lane is not None and lane.dtype == torch.int32:
        out.view(torch.int32)[:, 3] = lane
    elif lane is not None:
        out[:, 3] = lane
    return out


def _d2(pts: torch.Tensor, rows: torch.Tensor,
        cols: torch.Tensor) -> torch.Tensor:
    """``pair_d2`` of packed rows between flat row and column slots."""
    return pair_d2(pts.T, rows[:, None], cols[:, None]).reshape(-1)


def column_windows(pts: torch.Tensor, col: torch.Tensor,
                   colstart: torch.Tensor, ny: int, r0: int, r1: int
                   ) -> torch.Tensor:
    """(r1 - r0, 9, 2) int64 windows (start, count) that ``detect`` scans
    for rows [r0, r1): for each (dx, dy) in {-1, 0, 1}^2 whose z-column
    lies on the grid, the slots of that column -- within
    [colstart[c], colstart[c + 1]) -- whose z cell is within one of the
    row's; count 0 off the grid.  Slots sort on (z-column, z cell), so a
    column's z cells cz-1..cz+1 are two binary searches of one key."""
    cz = pts.view(torch.int32)[:, 3].long()
    col = col.long()
    cs = colstart.long()
    nx = (cs.shape[0] - 1) // ny
    span = int(cz.max()) + 3            # z cells -1..max + 1, shifted by 1
    key = col * span + cz + 1
    x = torch.div(col[r0:r1], ny, rounding_mode="floor")
    y = col[r0:r1] - x * ny
    z = cz[r0:r1]
    out = torch.zeros(r1 - r0, NWIN, 2, dtype=torch.int64, device=pts.device)
    for k, (dx, dy) in enumerate((dx, dy) for dx in (-1, 0, 1)
                                 for dy in (-1, 0, 1)):
        qx, qy = x + dx, y + dy
        inside = (qx >= 0) & (qx < nx) & (qy >= 0) & (qy < ny)
        c = torch.where(inside, qx * ny + qy, 0)
        lo, hi = cs[c], cs[c + 1]
        first = torch.searchsorted(key, c * span + z)          # z cell cz-1
        end = torch.searchsorted(key, c * span + z + 2, right=True)
        first = torch.minimum(torch.maximum(first, lo), hi)
        end = torch.minimum(torch.maximum(end, first), hi)
        out[:, k, 0] = first
        out[:, k, 1] = torch.where(inside, end - first, 0)
    return out


def detect_ref(pts: torch.Tensor, col: torch.Tensor, colstart: torch.Tensor,
               ny: int, b2: float, rows_per_batch: int = 1 << 21
               ) -> torch.Tensor:
    ns = pts.shape[0]
    out = torch.zeros(ns, dtype=torch.int32, device=pts.device)
    for r0 in range(0, ns, rows_per_batch):
        r1 = min(r0 + rows_per_batch, ns)
        win = column_windows(pts, col, colstart, ny, r0, r1)
        own = torch.arange(r1 - r0, device=pts.device)
        for rows, cols in cell_pairs(own, win):
            rows = rows + r0
            linked = rows[_d2(pts, rows, cols) <= b2]
            out.index_add_(0, linked, torch.ones_like(linked,
                                                      dtype=torch.int32))
    return out


def sweep3d_ref(pts: torch.Tensor, labels: torch.Tensor, cell: torch.Tensor,
                win: torch.Tensor, b2: float) -> torch.Tensor:
    out = labels.clone()
    for rows, cols in cell_pairs(cell, win):
        hit = _d2(pts, rows, cols) <= b2
        out.scatter_reduce_(0, rows[hit], labels[cols[hit]], "amin")
    return out


def sweep6d_ref(pts: torch.Tensor, vels: torch.Tensor, labels: torch.Tensor,
                cell: torch.Tensor, win: torch.Tensor,
                inv_b2: float) -> torch.Tensor:
    grp = pts.view(torch.int32)[:, 3]
    rivs = vels[:, 3]
    out = labels.clone()
    for rows, cols in cell_pairs(cell, win):
        g = grp[rows]
        same = (g > 0) & (g == grp[cols])
        rows, cols = rows[same], cols[same]
        phase = (_d2(pts, rows, cols) * inv_b2 +
                 _d2(vels, rows, cols) * rivs[rows])
        hit = phase <= 1.0
        out.scatter_reduce_(0, rows[hit], labels[cols[hit]], "amin")
    return out


def detect(pts: torch.Tensor, col: torch.Tensor, colstart: torch.Tensor,
           ny: int, b2: float) -> torch.Tensor:
    """(ns,) int32 neighbour counts within sqrt(b2), self included; ``pts``
    packed (x, y, z, z cell bits) rows, (``col``, ``colstart``) the column
    index of a grid with ``ny`` cells along y."""
    ns, nx = check_columns(pts, col, colstart, ny)
    b2 = f32(b2)
    if not kernel_device(pts):
        return detect_ref(pts, col, colstart, ny, b2)
    out = torch.empty(ns, dtype=torch.int32, device=pts.device)
    if ns:
        with on_device(pts):
            check(load_library().vr_fof_detect(
                pts.data_ptr(), col.data_ptr(), colstart.data_ptr(), ns, nx,
                ny, b2, out.data_ptr(), stream(pts)), "vr_fof_detect")
        LAUNCHES["fof_detect"] += 1
    return out


def sweep3d(pts: torch.Tensor, labels: torch.Tensor, cell: torch.Tensor,
            win: torch.Tensor, b2: float) -> torch.Tensor:
    """(ns,) int32 minimum label over each slot and its 3D links; ``pts``
    packed (x, y, z, .) rows."""
    ns = check_cells(pts, NWIN, cell, win)
    require(labels, "labels", torch.int32, (ns,), pts.device)
    b2 = f32(b2)
    if not kernel_device(pts):
        return sweep3d_ref(pts, labels, cell, win, b2)
    out = torch.empty(ns, dtype=torch.int32, device=pts.device)
    if ns:
        with on_device(pts):
            check(load_library().vr_fof_sweep3d(
                pts.data_ptr(), labels.data_ptr(), cell.data_ptr(),
                win.data_ptr(), ns, b2, out.data_ptr(), stream(pts)),
                "vr_fof_sweep3d")
        LAUNCHES["fof_sweep3d"] += 1
    return out


def sweep6d(pts: torch.Tensor, vels: torch.Tensor, labels: torch.Tensor,
            cell: torch.Tensor, win: torch.Tensor,
            inv_b2: float) -> torch.Tensor:
    """(ns,) int32 minimum label over each slot and its 6D links.  ``pts``
    packs (x, y, z, int32 3DFOF group bits) per slot (group 0 links to
    nothing), ``vels`` (vx, vy, vz, rivs) with rivs = 1/max(vscale2,
    1e-30)."""
    ns = check_cells(pts, NWIN, cell, win)
    require(vels, "vels", torch.float32, (ns, 4), pts.device)
    require(labels, "labels", torch.int32, (ns,), pts.device)
    inv_b2 = f32(inv_b2)
    if not kernel_device(pts):
        return sweep6d_ref(pts, vels, labels, cell, win, inv_b2)
    out = torch.empty(ns, dtype=torch.int32, device=pts.device)
    if ns:
        with on_device(pts):
            check(load_library().vr_fof_sweep6d(
                pts.data_ptr(), vels.data_ptr(), labels.data_ptr(),
                cell.data_ptr(), win.data_ptr(), ns, inv_b2, out.data_ptr(),
                stream(pts)), "vr_fof_sweep6d")
        LAUNCHES["fof_sweep6d"] += 1
    return out
