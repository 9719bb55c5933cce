"""FOF neighbour scans: wrappers of ``csrc/fof_sweep.cu`` and their plain
PyTorch versions.

All three take cell-sorted slots (``ops/fof_sweep.py``).

* ``detect``  <- ``_detect_kernel_3d`` (ops/pallas_fof.py:613): per slot,
  the number of candidates with |dx|^2 <= b2, itself included.  It takes
  positions as a (3, ns) float32 tensor and, per row block of ``R_BLOCK``
  slots, the (nblocks, 9, 2) int32 block windows -- (start, count) slot
  ranges, disjoint, jointly an exact superset of the block's neighbours.
* ``sweep3d`` <- ``_sweep_kernel_3d`` (:578): per slot, the minimum label
  over its own and the candidates' with |dx|^2 <= b2.
* ``sweep6d`` <- ``_sweep_kernel_6d`` (:680): per slot, the minimum label
  over its own and the candidates' with d2*inv_b2 + dv2*rivs_row <= 1 in
  the same nonzero group.

The sweeps take each row's own cell windows (``ops/fof_sweep.py::
cell_windows``): ``cell`` (ns,) int32, the row's cell, and ``win``
(ncell, 9, 2) int32, each cell's nine (start, count) ranges of the slots
of its 27 cells.  Columns come packed (``pack``): (ns, 4) float32 rows
(x, y, z, .), for the 6D sweep (x, y, z, group bits) and
(vx, vy, vz, rivs).  A row whose cell has empty windows keeps its label.

``detect_ref`` takes an optional ``blocks`` subset of row blocks; rows of
other blocks get count 0.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import LAUNCHES
from ._build import check, load_library
from ._common import (BIG_I32, cell_pairs, check_cells, check_rows, f32,
                      kernel_device, pair_d2, require, stream, window_tiles)

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


def detect_ref(pos: torch.Tensor, windows: torch.Tensor, b2: float,
               blocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    ns = pos.shape[1]
    out = torch.zeros(ns, dtype=torch.int32, device=pos.device)
    for rows, rvalid, cols, cvalid in window_tiles(windows, ns, blocks):
        hit = (pair_d2(pos, rows, cols) <= b2) & cvalid[:, None, :]
        cnt = hit.sum(-1, dtype=torch.int32)
        out[rows[rvalid]] += cnt[rvalid]
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


def detect(pos: torch.Tensor, windows: torch.Tensor,
           b2: float) -> torch.Tensor:
    """(ns,) int32 neighbour counts within sqrt(b2), self included."""
    ns = check_rows(pos, NWIN, windows)
    b2 = f32(b2)
    if not kernel_device(pos):
        return detect_ref(pos, windows, b2)
    out = torch.empty(ns, dtype=torch.int32, device=pos.device)
    if ns:
        check(load_library().vr_fof_detect(
            pos.data_ptr(), ns, windows.data_ptr(), b2, out.data_ptr(),
            stream(pos)), "vr_fof_detect")
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
        check(load_library().vr_fof_sweep6d(
            pts.data_ptr(), vels.data_ptr(), labels.data_ptr(),
            cell.data_ptr(), win.data_ptr(), ns, inv_b2, out.data_ptr(),
            stream(pts)), "vr_fof_sweep6d")
        LAUNCHES["fof_sweep6d"] += 1
    return out
