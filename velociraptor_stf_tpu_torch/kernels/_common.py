"""Argument checks and the row-block tiling shared by the kernel wrappers
and their plain PyTorch versions."""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

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


def check_rows(pos: torch.Tensor, nwin: int,
               windows: torch.Tensor) -> int:
    """Validate the (3, ns) float32 positions and the (nblocks, nwin, 2)
    int32 windows of one launch; return ns."""
    if pos.dim() != 2 or pos.shape[0] != 3:
        raise ValueError(f"pos: expected shape (3, ns), got "
                         f"{tuple(pos.shape)}")
    ns = int(pos.shape[1])
    if ns >= 2**31:
        raise ValueError(f"{ns} rows exceed the kernels' int32 indexing")
    require(pos, "pos", torch.float32, (3, ns), pos.device)
    nblocks = -(-ns // R_BLOCK)
    require(windows, "windows", torch.int32, (nblocks, nwin, 2), pos.device)
    return ns


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
