"""Direct-sum group potential: wrapper of ``csrc/potential.cu`` and its
plain PyTorch version.

``potential`` <- ``_pot_kernel`` (ops/pallas_gravity.py:40).  Over
group-sorted slots, phi_i = sum_j m_j / sqrt(|x_i - x_j|^2 + eps2) for
j != i with gid_j == gid_i != 0; the caller multiplies by -G and m_i.
Each row i comes with its group's slot range ``windows[i] = [start, end)``,
(0, 0) for gid 0 (``ops/gravity_direct.py::block_window``).

Launch geometry (built here, so the tests can check it): a block of
``THREADS`` threads holds ``ROWS_PER_THREAD`` consecutive rows per thread;
a row block's columns are the union of its rows' ranges (``spans``),
widened down to a multiple of ``TILE`` and cut into chunks of whole tiles
(``work_items``), one thread block per chunk; each thread scans only the
union of its own rows' ranges.  A second pass adds a row's chunk sums in
chunk order.

Summation order: a row's float32 partial sums run over the tiles
[k TILE, (k + 1) TILE) of absolute column index, in both the kernel and
the plain version, so a row's result depends only on its group's slots
modulo ``TILE``: a group laid out at the same offset modulo ``TILE`` gets
the same bits in another array (the mesh unbind's shard blocks,
``parallel/distributed_unbind.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import LAUNCHES, R_BLOCK
from ._build import check, load_library
from ._common import f32, kernel_device, on_device, pair_d2, require, \
    stream, window_tiles

THREADS = 128
ROWS_PER_THREAD = 4
ROWS_PER_BLOCK = THREADS * ROWS_PER_THREAD
TILE = 256                 # columns per shared-memory stage
MIN_CHUNK = 16 * TILE      # the fewest columns a work item scans
# work items of one launch: about 8 waves of the 132 SMs x 8 resident
# blocks that the kernel's registers allow
TARGET_ITEMS = 8192


def spans(windows: torch.Tensor, rows: int) -> torch.Tensor:
    """(nblocks, 2) int64 union [start, end) of the nonempty row ranges
    ``windows`` over each run of ``rows`` consecutive rows; (0, 0) where
    no row has partners."""
    ns = int(windows.shape[0])
    nb = -(-ns // rows)
    w = torch.zeros(nb * rows, 2, dtype=torch.int64, device=windows.device)
    w[:ns] = windows
    w = w.view(nb, rows, 2)
    has = w[:, :, 1] > w[:, :, 0]
    big = torch.iinfo(torch.int64).max
    lo = torch.where(has, w[:, :, 0], big).amin(1)
    hi = torch.where(has, w[:, :, 1], 0).amax(1)
    any_ = has.any(1)
    return torch.stack([torch.where(any_, lo, 0), torch.where(any_, hi, 0)],
                       1)


def work_items(windows: torch.Tensor):
    """(items, first): (nitems, 4) int32 work items (row block, first
    column, end column, 0), each a chunk of a whole number of tiles of its
    row block's span, in row-block order and within it in column order;
    (nblocks + 1,) int32 ``first``, block b's items being
    ``items[first[b]:first[b + 1]]``.  A block with an empty span has one
    empty item, so every row is written."""
    sp = spans(windows, ROWS_PER_BLOCK)
    sp[:, 0] -= sp[:, 0] % TILE         # tiles at absolute multiples
    length = sp[:, 1] - sp[:, 0]
    total = int(length.sum())
    chunk = max(MIN_CHUNK, -(-total // (TARGET_ITEMS * TILE)) * TILE)
    nchunk = torch.clamp_min(-(-length // chunk), 1)
    first = torch.zeros(sp.shape[0] + 1, dtype=torch.int64,
                        device=windows.device)
    torch.cumsum(nchunk, 0, out=first[1:])
    block = torch.repeat_interleave(
        torch.arange(sp.shape[0], device=windows.device), nchunk,
        output_size=int(first[-1]))
    k = torch.arange(block.shape[0], device=windows.device) - first[block]
    begin = sp[block, 0] + k * chunk
    end = torch.minimum(begin + chunk, sp[block, 1])
    items = torch.stack([block, begin, end, torch.zeros_like(block)], 1)
    return items.to(torch.int32).contiguous(), first.to(torch.int32)


def pairs_tested(windows: torch.Tensor) -> int:
    """(row, column) pairs the kernel evaluates: every row of a thread
    against the union of that thread's rows' ranges."""
    s = spans(windows, ROWS_PER_THREAD)
    return int(ROWS_PER_THREAD * (s[:, 1] - s[:, 0]).sum())


def edge_case(seed: int = 5):
    """(pos (n, 3) float32, mass, gid int64, offsets (ng + 2,)): group-sorted
    rows at every edge of the launch geometry -- a gid-0 run of two whole
    row blocks and more first, a gid-0 run in the middle (a group left to
    the tree, still in ``offsets``), groups of 1-3 members, groups
    straddling thread and block edges, a coincident pair in the group at
    the array tail, and rows not a multiple of a block.  CPU tensors."""
    rng = np.random.default_rng(seed)
    B, P = ROWS_PER_BLOCK, ROWS_PER_THREAD
    sizes = [1, 2, 3, 1, B - 5, 2 * B + 3, P + 1, 3, 37, 1, 700, 2, 3]
    g = np.concatenate([np.zeros(2 * B + 7, np.int64)] +
                       [np.full(s, i + 1) for i, s in enumerate(sizes)])
    offsets = torch.searchsorted(torch.from_numpy(g),
                                 torch.arange(len(sizes) + 2))
    g[g == 6] = 0                      # the tree's group: gid 0
    pos = rng.normal(0, 1, (len(g), 3)).astype(np.float32)
    pos[-1] = pos[-2]                  # coincident, in the tail group
    mass = rng.uniform(0.5, 2, len(g)).astype(np.float32)
    return (torch.from_numpy(pos), torch.from_numpy(mass),
            torch.from_numpy(g), offsets)


def potential_ref(pos: torch.Tensor, mass: torch.Tensor, gid: torch.Tensor,
                  windows: torch.Tensor, eps2: float,
                  blocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: f32 terms, summed in f32 over the kernel's column
    tiles (``TILE`` columns at absolute multiples of ``TILE``) and the
    tiles in f64, over the spans of ``R_BLOCK``-row blocks (rows outside
    ``blocks``, indices of such blocks, stay 0)."""
    ns = pos.shape[1]
    s = spans(windows, R_BLOCK)
    lo = s[:, 0] - s[:, 0] % TILE
    win = torch.stack([lo, torch.where(s[:, 1] > s[:, 0], s[:, 1] - lo, 0)],
                      1)[:, None, :]
    acc = torch.zeros(ns, dtype=torch.float64, device=pos.device)
    for rows, rvalid, cols, cvalid in window_tiles(win, ns, blocks,
                                                   cols_per_tile=TILE):
        g = gid[rows][:, :, None]
        hit = ((g == gid[cols][:, None, :]) & (g > 0) &
               (rows[:, :, None] != cols[:, None, :]) & cvalid[:, None, :])
        term = mass[cols][:, None, :] * torch.rsqrt(
            pair_d2(pos, rows, cols) + eps2)
        term = torch.where(hit, term, 0.0)
        # a short last tile is summed at full width, as every other tile
        part = torch.nn.functional.pad(
            term, (0, TILE - term.shape[-1])).sum(-1)
        acc[rows[rvalid]] += part[rvalid].double()
    return acc.float()


def potential(pos: torch.Tensor, mass: torch.Tensor, gid: torch.Tensor,
              windows: torch.Tensor, eps2: float) -> torch.Tensor:
    """(ns,) float32 unscaled group potential of group-sorted slots; ``pos``
    (3, ns) float32, ``windows`` (ns, 2) int32 row ranges."""
    if pos.dim() != 2 or pos.shape[0] != 3:
        raise ValueError(f"pos: expected shape (3, ns), got "
                         f"{tuple(pos.shape)}")
    ns = int(pos.shape[1])
    if ns >= 2**31 - ROWS_PER_BLOCK:
        raise ValueError(f"{ns} rows exceed the kernel's int32 indexing")
    require(pos, "pos", torch.float32, (3, ns), pos.device)
    require(mass, "mass", torch.float32, (ns,), pos.device)
    require(gid, "gid", torch.int32, (ns,), pos.device)
    require(windows, "windows", torch.int32, (ns, 2), pos.device)
    eps2 = f32(eps2)
    if not kernel_device(pos):
        return potential_ref(pos, mass, gid, windows, eps2)
    out = torch.empty(ns, dtype=torch.float32, device=pos.device)
    if ns:
        lib = load_library()
        packed = torch.cat([pos.T, mass[:, None]], 1).contiguous()
        items, first = work_items(windows)
        scratch = torch.empty(items.shape[0], ROWS_PER_BLOCK,
                              dtype=torch.float64, device=pos.device)
        with on_device(pos):
            check(lib.vr_potential(packed.data_ptr(), windows.data_ptr(), ns,
                                   items.data_ptr(), items.shape[0],
                                   first.data_ptr(), eps2, scratch.data_ptr(),
                                   out.data_ptr(), stream(pos)),
                  "vr_potential")
        LAUNCHES["potential"] += 1
    return out
