"""Uniform cell grid and Morton keys (port of
velociraptor_stf_tpu/ops/cells.py: ``build_grid``, ``cell_coords``,
``pack_cells``, ``unpack_cells``, ``bin_particles`` and ``morton_keys``).

``build_grid`` is host numpy in the reference too; its logic is copied here
because the reference module imports jax.  A cell is at least the search
radius wide, so the 27-cell stencil holds every candidate.  The FOF sweep
uses open grids (periodic boxes get ghost images there); the SO search uses
the periodic grid, whose coordinates wrap.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

MAX_TOTAL_CELLS = 2**62     # cell keys cx * ny * nz + cr stay in int64


class CellGrid(NamedTuple):
    """Host-side grid geometry.  A periodic grid spans [0, boxsize) with
    ``ncells * width == boxsize``; whether a grid wraps is the caller's
    (``periodic`` of ``cell_coords`` / ``bin_particles``)."""

    ncells: Tuple[int, int, int]
    origin: Tuple[float, float, float]
    width: Tuple[float, float, float]     # cell width per axis


def build_grid(lo: np.ndarray, hi: np.ndarray, min_width: float,
               periodic: bool = False, boxsize: float = 0.0,
               max_total_cells: int = MAX_TOTAL_CELLS) -> CellGrid:
    """Cells at least ``min_width`` wide over [lo, hi] (padded slightly so
    points on the upper boundary land inside), or over [0, boxsize) when
    ``periodic``.  The cell count per axis halves until the total is at
    most ``max_total_cells`` (the reference caps it at 2**31 - 1 for its
    int32 cell ids)."""
    if periodic:
        if not boxsize > 0:
            raise ValueError("a periodic grid needs boxsize > 0")
        extent = np.full(3, float(boxsize))
        lo = np.zeros(3)
    else:
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        extent = np.maximum(hi - lo, 1e-30)
        extent = extent * (1 + 1e-6) + 1e-30
    nc = np.maximum(1, np.floor(extent / max(min_width, 1e-30)).astype(
        np.int64))
    cap = min(max_total_cells, MAX_TOTAL_CELLS)
    while int(np.prod(nc)) > cap:
        nc = np.maximum(1, nc // 2)
    width = extent / nc
    return CellGrid(ncells=(int(nc[0]), int(nc[1]), int(nc[2])),
                    origin=(float(lo[0]), float(lo[1]), float(lo[2])),
                    width=(float(width[0]), float(width[1]),
                           float(width[2])))


def limit_columns(grid: CellGrid, max_columns: int,
                  max_depth: int = 2**31 - 2) -> CellGrid:
    """``grid`` over the same extent with ``nx`` and ``ny`` halved until
    the z-columns ``nx * ny`` number at most ``max_columns`` (at least 1),
    and ``nz`` halved until it is at most ``max_depth``.  Cells only get
    wider, so a stencil that held every candidate still does."""
    nc = np.array(grid.ncells, np.int64)
    extent = np.array(grid.width) * nc
    while nc[0] * nc[1] > max(max_columns, 1):
        nc[:2] = np.maximum(1, nc[:2] // 2)
    while nc[2] > max_depth:
        nc[2] //= 2
    if tuple(nc) == tuple(grid.ncells):
        return grid
    width = extent / nc
    return CellGrid(ncells=(int(nc[0]), int(nc[1]), int(nc[2])),
                    origin=grid.origin,
                    width=(float(width[0]), float(width[1]),
                           float(width[2])))


def cell_coords(pos: torch.Tensor, grid: CellGrid,
                periodic: bool = False) -> torch.Tensor:
    """(N, 3) int64 cell coordinates of (N, 3) positions, computed in the
    positions' dtype as the reference does: wrapped into a ``periodic``
    grid, else clamped."""
    origin = torch.tensor(grid.origin, dtype=pos.dtype, device=pos.device)
    width = torch.tensor(grid.width, dtype=pos.dtype, device=pos.device)
    nc = torch.tensor(grid.ncells, dtype=torch.int64, device=pos.device)
    c = torch.floor((pos - origin) / width).long()
    if periodic:
        return torch.remainder(c, nc)
    return torch.minimum(torch.clamp(c, min=0), nc - 1)


def bin_segments(pos: torch.Tensor, seg: torch.Tensor,
                 grids: Sequence[CellGrid]
                 ) -> Tuple[torch.Tensor, torch.Tensor, CellGrid]:
    """``bin_particles`` for many disjoint point sets at once: row i
    belongs to set ``seg[i]`` (non-decreasing) and is binned on that
    set's open grid ``grids[seg[i]]``, its cell coordinates computed as
    ``cell_coords`` computes them.  The sets lie side by side along x in
    one grid (set s at x offset sum over t < s of nx_t + 1, so an empty
    x column separates two sets and no 27-cell stencil reaches from one
    into another; ny and nz the largest of the sets').  Returns (order,
    cid_sorted, that grid): the stable sort by (set, cell) -- within a
    set, the order ``bin_particles`` gives on its own grid, since both
    sort lexicographically by (cx, cy, cz)."""
    dev = pos.device
    nc_h = np.array([g.ncells for g in grids], np.int64).reshape(-1, 3)
    xoff = np.concatenate([[0], np.cumsum(nc_h[:, 0] + 1)[:-1]])
    shape = (int(nc_h[:, 0].sum() + len(grids)), int(nc_h[:, 1].max()),
             int(nc_h[:, 2].max()))
    if float(np.prod(np.array(shape, np.float64))) > MAX_TOTAL_CELLS:
        raise ValueError(f"{len(grids)} cell grids side by side need "
                         f"{shape} cells, over {MAX_TOTAL_CELLS}")
    joint = CellGrid(ncells=shape, origin=(0.0, 0.0, 0.0),
                     width=(1.0, 1.0, 1.0))
    origin = torch.tensor(np.array([g.origin for g in grids]),
                          dtype=pos.dtype, device=dev)[seg]
    width = torch.tensor(np.array([g.width for g in grids]),
                         dtype=pos.dtype, device=dev)[seg]
    nc = torch.from_numpy(nc_h).to(dev)[seg]
    c = torch.floor((pos - origin) / width).long()
    c = torch.minimum(torch.clamp(c, min=0), nc - 1)
    c[:, 0] += torch.from_numpy(xoff).to(dev)[seg]
    cid = pack_cells(c, joint)
    order = torch.argsort(cid, stable=True)
    return order, cid[order], joint


def pack_cells(coords: torch.Tensor, grid: CellGrid) -> torch.Tensor:
    """(..., 3) cell coordinates -> int64 linear cell ids."""
    _, ny, nz = grid.ncells
    return (coords[..., 0] * ny + coords[..., 1]) * nz + coords[..., 2]


def unpack_cells(cid: torch.Tensor, grid: CellGrid) -> torch.Tensor:
    """int64 linear cell ids -> (..., 3) cell coordinates."""
    _, ny, nz = grid.ncells
    return torch.stack([torch.div(cid, ny * nz, rounding_mode="floor"),
                        torch.div(cid, nz, rounding_mode="floor") % ny,
                        cid % nz], -1)


def bin_particles(pos: torch.Tensor, grid: CellGrid, periodic: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, cid_sorted): the stable permutation sorting particles by
    linear cell id, and the sorted ids (the reference's ``lean``
    binning)."""
    cid = pack_cells(cell_coords(pos, grid, periodic), grid)
    order = torch.argsort(cid, stable=True)
    return order, cid[order]


def _spread_bits_10(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int64 ``x`` two zero bits apart."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_keys(pos: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                bits: int = 10) -> torch.Tensor:
    """(..., ) int64 Morton (Z-order) keys of (..., 3) positions within
    [lo, hi] (broadcast against ``pos``); the cell index per axis is
    computed in the positions' dtype, as the reference does."""
    scale = (2 ** bits - 1) / torch.clamp_min(hi - lo, 1e-30)
    c = torch.clamp((pos - lo) * scale, 0, 2 ** bits - 1).long()
    return (_spread_bits_10(c[..., 0]) << 2) | \
        (_spread_bits_10(c[..., 1]) << 1) | _spread_bits_10(c[..., 2])
