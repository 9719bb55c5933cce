"""Argument checks, and the enumerations of window columns, shared by the
kernel wrappers and their plain PyTorch versions."""

from __future__ import annotations

import weakref
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import R_BLOCK

BIG_I32 = 2**31 - 1


def f32(x: float) -> float:
    """``x`` rounded to float32, as the kernels receive it."""
    return float(np.float32(x))


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: Sequence[int], device: torch.device) -> None:
    """Raise unless ``t`` has the dtype, shape and device the kernel takes
    and is contiguous."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _packed_rows(pts: torch.Tensor) -> int:
    """Validate (ns, 4) float32 packed rows, which the kernels load as one
    float4 each; return ns."""
    if pts.dim() != 2 or pts.shape[1] != 4:
        raise ValueError(f"pts: expected shape (ns, 4), got "
                         f"{tuple(pts.shape)}")
    ns = int(pts.shape[0])
    if ns >= 2**31:
        raise ValueError(f"{ns} rows exceed the kernels' int32 indexing")
    require(pts, "pts", torch.float32, (ns, 4), pts.device)
    if pts.data_ptr() % 16:
        raise ValueError("pts must be 16-byte aligned")
    return ns


def check_columns(pts: torch.Tensor, col: torch.Tensor,
                  colstart: torch.Tensor, ny: int) -> Tuple[int, int]:
    """Validate the (ns, 4) float32 packed rows, the (ns,) int32 z-column
    of each row and the (nx * ny + 1,) int32 column starts of one detect
    launch, and that their contents stay in range; return (ns, nx)."""
    ns = _packed_rows(pts)
    require(col, "col", torch.int32, (ns,), pts.device)
    if colstart.dim() != 1 or ny < 1 or (colstart.shape[0] - 1) % ny or \
            colstart.shape[0] < 2:
        raise ValueError(f"colstart: expected shape (nx * {ny} + 1,), got "
                         f"{tuple(colstart.shape)}")
    ncol = int(colstart.shape[0]) - 1
    require(colstart, "colstart", torch.int32, (ncol + 1,), pts.device)
    _once(col, colstart, ns, lambda: _check_column_contents(col, colstart,
                                                            ns))
    return ns, ncol // ny


def check_cells(pts: torch.Tensor, nwin: int, cell: torch.Tensor,
                win: torch.Tensor) -> int:
    """Validate the (ns, 4) float32 packed rows, the (ns,) int32 cell of
    each row and the (ncell, nwin, 2) int32 cell windows of one launch,
    and that their contents stay in range; return ns.  The kernels load a
    window as one int2, so ``win`` must be aligned to it."""
    ns = _packed_rows(pts)
    require(cell, "cell", torch.int32, (ns,), pts.device)
    if win.dim() != 3:
        raise ValueError(f"win: expected shape (ncell, {nwin}, 2), got "
                         f"{tuple(win.shape)}")
    require(win, "win", torch.int32, (win.shape[0], nwin, 2), pts.device)
    if win.data_ptr() % 8:
        raise ValueError("win must be 8-byte aligned")
    _once(cell, win, ns, lambda: _check_cell_contents(cell, win, ns))
    return ns


# table -> (per-row tensor, the versions of both and ns) of a pair whose
# contents passed their check; an in-place change bumps a version
_CHECKED = WeakIdKeyDictionary()


def _once(rows: torch.Tensor, table: torch.Tensor, ns: int,
          check: Callable[[], None]) -> None:
    """Run ``check`` (which raises on bad contents, with one host sync)
    unless it passed for this pair of tensors and neither has changed
    since, so the launches over one index pay it once."""
    stamp = (rows._version, table._version, ns)
    seen = _CHECKED.get(table)
    if seen is not None and seen[0]() is rows and seen[1] == stamp:
        return
    check()
    _CHECKED[table] = (weakref.ref(rows), stamp)


def _check_cell_contents(cell: torch.Tensor, win: torch.Tensor,
                         ns: int) -> None:
    """Raise unless every cell number indexes ``win`` and every window
    (start, count) lies in [0, ns): the kernels would read out of bounds."""
    bad = torch.zeros(2, dtype=torch.bool, device=cell.device)
    if cell.numel():
        lo, hi = torch.aminmax(cell)
        bad[0] = (lo < 0) | (hi >= win.shape[0])
    if win.numel():
        start, count = win[..., 0], win[..., 1]
        bad[1] = ((start.amin() < 0) | (count.amin() < 0) |
                  ((start.long() + count).amax() > ns))
    cell_bad, win_bad = bad.tolist()
    if cell_bad:
        raise ValueError(f"cell: a cell number outside [0, {win.shape[0]})")
    if win_bad:
        raise ValueError(f"win: a window outside the {ns} rows")


def _check_column_contents(col: torch.Tensor, colstart: torch.Tensor,
                           ns: int) -> None:
    """Raise unless every row's z-column indexes ``colstart`` and the
    starts run from at least 0, never decreasing, to at most ns: the
    kernel would read out of bounds."""
    ncol = colstart.shape[0] - 1
    bad = torch.zeros(2, dtype=torch.bool, device=col.device)
    if col.numel():
        lo, hi = torch.aminmax(col)
        bad[0] = (lo < 0) | (hi >= ncol)
    bad[1] = ((colstart[0] < 0) | (colstart[-1] > ns) |
              (colstart[1:] < colstart[:-1]).any())
    col_bad, start_bad = bad.tolist()
    if col_bad:
        raise ValueError(f"col: a z-column outside [0, {ncol})")
    if start_bad:
        raise ValueError(f"colstart: not non-decreasing within [0, {ns}]")


def kernel_device(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device is refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def on_device(t: torch.Tensor):
    """Context making ``t``'s card the current device: a launch through
    the library's C interface runs on the current device, which need not
    hold the tensors (a mesh over several cards, or ``device="cuda:1"``)."""
    return torch.cuda.device(t.device)


def window_tiles(windows: torch.Tensor, ns: int,
                 blocks: Optional[torch.Tensor] = None,
                 cols_per_tile: int = 2048
                 ) -> Iterator[Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]]:
    """Enumerate, batch by batch, every (row, window column) pair of the
    row blocks ``blocks`` (default: all).

    Yields ``(rows, rvalid, cols, cvalid)``: (B, R) row slots and (B, C)
    column slots of B row blocks, each block's columns being the
    concatenation of its windows; invalid entries are clamped to slot 0.
    B * R * C stays under a budget, so no N x window array is formed."""
    device = windows.device
    nblocks, nwin, _ = windows.shape
    if blocks is None:
        blocks = torch.arange(nblocks, device=device)
    if ns == 0 or blocks.numel() == 0:
        return
    budget = (1 << 25) if device.type == "cuda" else (1 << 22)
    per_batch = max(1, budget // (R_BLOCK * cols_per_tile))
    w = windows.long()
    lane = torch.arange(R_BLOCK, device=device)
    for b0 in range(0, blocks.numel(), per_batch):
        bb = blocks[b0:b0 + per_batch].long()
        start, count = w[bb, :, 0], w[bb, :, 1]            # (B, nwin)
        cum = torch.cumsum(count, 1)
        first = cum - count                                # window offsets
        total = cum[:, -1]
        rows = bb[:, None] * R_BLOCK + lane[None, :]
        rvalid = rows < ns
        rows = torch.where(rvalid, rows, 0)
        length = int(total.max())
        for c0 in range(0, length, cols_per_tile):
            j = c0 + torch.arange(min(cols_per_tile, length - c0),
                                  device=device)
            j = j[None, :].expand(bb.numel(), -1).contiguous()
            k = torch.searchsorted(cum, j, right=True).clamp_(max=nwin - 1)
            cols = start.gather(1, k) + j - first.gather(1, k)
            cvalid = j < total[:, None]
            yield rows, rvalid, torch.where(cvalid, cols, 0), cvalid


def cell_pairs(cell: torch.Tensor, win: torch.Tensor
               ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Enumerate, batch by batch of consecutive rows, every (row, column)
    pair of each row's cell windows: yields flat int64 ``(rows, cols)``,
    in row, window and column order.  A batch holds at most a budget of
    pairs (or one row), so no rows x window array is formed."""
    device = win.device
    ns = int(cell.shape[0])
    if ns == 0:
        return
    budget = (1 << 24) if device.type == "cuda" else (1 << 22)
    cell = cell.long()
    length = win[:, :, 1].long()
    cum = torch.cumsum(length.sum(1)[cell], 0)
    nwin = win.shape[1]
    r0, done = 0, 0
    while r0 < ns:
        r1 = int(torch.searchsorted(cum, done + budget, right=True))
        r1 = min(max(r1, r0 + 1), ns)
        seg_len = length[cell[r0:r1]].reshape(-1)          # (rows * nwin,)
        seg_start = win[cell[r0:r1], :, 0].long().reshape(-1)
        total = int(cum[r1 - 1]) - done
        seg = torch.repeat_interleave(
            torch.arange(seg_len.shape[0], device=device), seg_len,
            output_size=total)
        first = torch.cumsum(seg_len, 0) - seg_len
        cols = seg_start[seg] + torch.arange(total, device=device) - first[seg]
        yield r0 + torch.div(seg, nwin, rounding_mode="floor"), cols
        r0, done = r1, done + total


def pair_d2(a: torch.Tensor, rows: torch.Tensor,
            cols: torch.Tensor) -> torch.Tensor:
    """(B, R, C) squared separations of (3, ns) vectors ``a`` between row
    and column slots, rounded as the kernels round them: dx*dx, + dy*dy,
    + dz*dz."""
    d = a[0][rows][:, :, None] - a[0][cols][:, None, :]
    d2 = d * d
    d = a[1][rows][:, :, None] - a[1][cols][:, None, :]
    d2 = d2 + d * d
    d = a[2][rows][:, :, None] - a[2][cols][:, None, :]
    return d2 + d * d
