"""FOF neighbour scans: wrappers of ``csrc/fof_sweep.cu`` and their plain
PyTorch versions.

All three take cell-sorted slots (``ops/fof_sweep.py``): positions as a
(3, ns) float32 tensor, and per row block of ``R_BLOCK`` slots the
(nblocks, 9, 2) int32 ``windows`` -- (start, count) slot ranges, disjoint,
jointly an exact superset of the block's neighbours.

* ``detect``  <- ``_detect_kernel_3d`` (ops/pallas_fof.py:613): per slot,
  the number of candidates with |dx|^2 <= b2, itself included.
* ``sweep3d`` <- ``_sweep_kernel_3d`` (:578): per slot, the minimum label
  over its own and the candidates' with |dx|^2 <= b2.
* ``sweep6d`` <- ``_sweep_kernel_6d`` (:680): per slot, the minimum label
  over its own and the candidates' with d2*inv_b2 + dv2*rivs_row <= 1 in
  the same nonzero group.

The plain versions take an optional ``blocks`` subset of row blocks; rows of
other blocks keep the value a block with no windows gives (count 0, own
label).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import LAUNCHES
from ._build import check, load_library
from ._common import (BIG_I32, check_rows, f32, kernel_device, pair_d2,
                      require, stream, window_tiles)

NWIN = 9


def detect_ref(pos: torch.Tensor, windows: torch.Tensor, b2: float,
               blocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    ns = pos.shape[1]
    out = torch.zeros(ns, dtype=torch.int32, device=pos.device)
    for rows, rvalid, cols, cvalid in window_tiles(windows, ns, blocks):
        hit = (pair_d2(pos, rows, cols) <= b2) & cvalid[:, None, :]
        cnt = hit.sum(-1, dtype=torch.int32)
        out[rows[rvalid]] += cnt[rvalid]
    return out


def sweep3d_ref(pos: torch.Tensor, labels: torch.Tensor,
                windows: torch.Tensor, b2: float,
                blocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    ns = pos.shape[1]
    out = labels.clone()
    for rows, rvalid, cols, cvalid in window_tiles(windows, ns, blocks):
        hit = (pair_d2(pos, rows, cols) <= b2) & cvalid[:, None, :]
        cand = torch.where(hit, labels[cols][:, None, :], BIG_I32)
        r = rows[rvalid]
        out[r] = torch.minimum(out[r], cand.amin(-1)[rvalid])
    return out


def sweep6d_ref(pos: torch.Tensor, vel: torch.Tensor, rivs: torch.Tensor,
                grp: torch.Tensor, labels: torch.Tensor,
                windows: torch.Tensor, inv_b2: float,
                blocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    ns = pos.shape[1]
    out = labels.clone()
    for rows, rvalid, cols, cvalid in window_tiles(windows, ns, blocks):
        phase = (pair_d2(pos, rows, cols) * inv_b2 +
                 pair_d2(vel, rows, cols) * rivs[rows][:, :, None])
        g = grp[rows][:, :, None]
        hit = ((phase <= 1.0) & (g == grp[cols][:, None, :]) & (g > 0) &
               cvalid[:, None, :])
        cand = torch.where(hit, labels[cols][:, None, :], BIG_I32)
        r = rows[rvalid]
        out[r] = torch.minimum(out[r], cand.amin(-1)[rvalid])
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


def sweep3d(pos: torch.Tensor, labels: torch.Tensor, windows: torch.Tensor,
            b2: float) -> torch.Tensor:
    """(ns,) int32 minimum label over each slot and its 3D links."""
    ns = check_rows(pos, NWIN, windows)
    require(labels, "labels", torch.int32, (ns,), pos.device)
    b2 = f32(b2)
    if not kernel_device(pos):
        return sweep3d_ref(pos, labels, windows, b2)
    out = torch.empty(ns, dtype=torch.int32, device=pos.device)
    if ns:
        check(load_library().vr_fof_sweep3d(
            pos.data_ptr(), labels.data_ptr(), ns, windows.data_ptr(), b2,
            out.data_ptr(), stream(pos)), "vr_fof_sweep3d")
        LAUNCHES["fof_sweep3d"] += 1
    return out


def sweep6d(pos: torch.Tensor, vel: torch.Tensor, rivs: torch.Tensor,
            grp: torch.Tensor, labels: torch.Tensor, windows: torch.Tensor,
            inv_b2: float) -> torch.Tensor:
    """(ns,) int32 minimum label over each slot and its 6D links.
    ``rivs`` = 1/max(vscale2, 1e-30) per slot (float32), ``grp`` the int32
    3DFOF group per slot (0 links to nothing)."""
    ns = check_rows(pos, NWIN, windows)
    require(vel, "vel", torch.float32, (3, ns), pos.device)
    require(rivs, "rivs", torch.float32, (ns,), pos.device)
    require(grp, "grp", torch.int32, (ns,), pos.device)
    require(labels, "labels", torch.int32, (ns,), pos.device)
    inv_b2 = f32(inv_b2)
    if not kernel_device(pos):
        return sweep6d_ref(pos, vel, rivs, grp, labels, windows, inv_b2)
    out = torch.empty(ns, dtype=torch.int32, device=pos.device)
    if ns:
        check(load_library().vr_fof_sweep6d(
            pos.data_ptr(), vel.data_ptr(), rivs.data_ptr(), grp.data_ptr(),
            labels.data_ptr(), ns, windows.data_ptr(), inv_b2,
            out.data_ptr(), stream(pos)), "vr_fof_sweep6d")
        LAUNCHES["fof_sweep6d"] += 1
    return out
