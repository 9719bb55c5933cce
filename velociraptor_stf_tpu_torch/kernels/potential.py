"""Direct-sum group potential: wrapper of ``csrc/potential.cu`` and its
plain PyTorch version.

``potential`` <- ``_pot_kernel`` (ops/pallas_gravity.py:40).  Over
group-sorted slots, phi_i = sum_j m_j / sqrt(|x_i - x_j|^2 + eps2) for
j != i with gid_j == gid_i != 0; the caller multiplies by -G and m_i.
Each row block of ``R_BLOCK`` slots owns one (start, count) window, given
as (nblocks, 1, 2) int32 ``windows`` (``ops/gravity_direct.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import LAUNCHES
from ._build import check, load_library
from ._common import (check_rows, f32, kernel_device, pair_d2, require,
                      stream, window_tiles)


def potential_ref(pos: torch.Tensor, mass: torch.Tensor, gid: torch.Tensor,
                  windows: torch.Tensor, eps2: float,
                  blocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: f32 terms, each tile summed in f32 and the tiles in
    f64, as the kernel does (rows outside ``blocks`` stay 0)."""
    ns = pos.shape[1]
    acc = torch.zeros(ns, dtype=torch.float64, device=pos.device)
    for rows, rvalid, cols, cvalid in window_tiles(windows, ns, blocks):
        g = gid[rows][:, :, None]
        hit = ((g == gid[cols][:, None, :]) & (g > 0) &
               (rows[:, :, None] != cols[:, None, :]) & cvalid[:, None, :])
        term = mass[cols][:, None, :] * torch.rsqrt(
            pair_d2(pos, rows, cols) + eps2)
        part = torch.where(hit, term, 0.0).sum(-1)
        acc[rows[rvalid]] += part[rvalid].double()
    return acc.float()


def potential(pos: torch.Tensor, mass: torch.Tensor, gid: torch.Tensor,
              windows: torch.Tensor, eps2: float) -> torch.Tensor:
    """(ns,) float32 unscaled group potential of group-sorted slots."""
    ns = check_rows(pos, 1, windows)
    require(mass, "mass", torch.float32, (ns,), pos.device)
    require(gid, "gid", torch.int32, (ns,), pos.device)
    eps2 = f32(eps2)
    if not kernel_device(pos):
        return potential_ref(pos, mass, gid, windows, eps2)
    out = torch.empty(ns, dtype=torch.float32, device=pos.device)
    if ns:
        check(load_library().vr_potential(
            pos.data_ptr(), mass.data_ptr(), gid.data_ptr(), ns,
            windows.data_ptr(), eps2, out.data_ptr(), stream(pos)),
            "vr_potential")
        LAUNCHES["potential"] += 1
    return out
