"""Uniform cell grid (port of velociraptor_stf_tpu/ops/cells.py:37-124, the
non-periodic case the sweep uses: periodic boxes get ghost images instead).

``build_grid`` is host numpy in the reference too; its logic is copied here
because the reference module imports jax.  A cell is at least the search
radius wide, so the 27-cell stencil holds every candidate.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

MAX_TOTAL_CELLS = 2**62     # cell keys cx * ny * nz + cr stay in int64


class CellGrid(NamedTuple):
    """Host-side grid geometry."""

    ncells: Tuple[int, int, int]
    origin: Tuple[float, float, float]
    width: Tuple[float, float, float]     # cell width per axis


def build_grid(lo: np.ndarray, hi: np.ndarray, min_width: float
               ) -> CellGrid:
    """Cells at least ``min_width`` wide over [lo, hi] (padded slightly so
    points on the upper boundary land inside)."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    extent = np.maximum(hi - lo, 1e-30)
    extent = extent * (1 + 1e-6) + 1e-30
    nc = np.maximum(1, np.floor(extent / max(min_width, 1e-30)).astype(
        np.int64))
    while int(np.prod(nc)) > MAX_TOTAL_CELLS:
        nc = np.maximum(1, nc // 2)
    width = extent / nc
    return CellGrid(ncells=(int(nc[0]), int(nc[1]), int(nc[2])),
                    origin=(float(lo[0]), float(lo[1]), float(lo[2])),
                    width=(float(width[0]), float(width[1]),
                           float(width[2])))


def cell_coords(pos: torch.Tensor, grid: CellGrid) -> torch.Tensor:
    """(N, 3) int64 cell coordinates of (N, 3) positions, computed in the
    positions' dtype as the reference does, clamped into the grid."""
    origin = torch.tensor(grid.origin, dtype=pos.dtype, device=pos.device)
    width = torch.tensor(grid.width, dtype=pos.dtype, device=pos.device)
    nc = torch.tensor(grid.ncells, dtype=torch.int64, device=pos.device)
    c = torch.floor((pos - origin) / width).long()
    return torch.minimum(torch.clamp(c, min=0), nc - 1)
