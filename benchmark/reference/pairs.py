"""Candidate pairs within a reach, over a periodic cell grid (plain torch).

Query points and reference points are binned on one grid of cells at
least ``reach`` wide; each query point meets the reference points of its
27 cells.  Candidates come in chunks of at most ``budget`` so that the
card's memory holds them; the caller applies its own criterion.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]


def budget_for(device: torch.device) -> int:
    return (1 << 25) if device.type == "cuda" else (1 << 20)


# query windows (27 a query point) held at once: the query points go in
# blocks of at most WINDOWS // 27, each with its own window tables, so
# that a volume of hundreds of millions of points fits the card
WINDOWS = 1 << 28


def _cells(pos: torch.Tensor, box: float, nc: int) -> torch.Tensor:
    c = torch.floor(pos.double() * (nc / box)).long()
    return torch.clamp(c, 0, nc - 1)


def _cell_keys(pos: torch.Tensor, box: float, nc: int) -> torch.Tensor:
    """(x * nc + y) * nc + z of each point's cell, a column at a time."""
    key = None
    for d in range(3):
        c = _cells(pos[:, d], box, nc)
        key = c if key is None else key * nc + c
    return key


def neighbour_pairs(qpos: torch.Tensor, rpos: torch.Tensor, reach: float,
                    box: float, budget: Optional[int] = None
                    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Chunks of (query index, reference index) for every reference
    point in the 27 cells around each query point; cells are at least
    ``reach`` wide in a periodic box of side ``box``, so every pair
    within ``reach`` (minimum image) is among them, once."""
    dev = qpos.device
    budget = budget or budget_for(dev)
    nc = max(1, int(box // reach))
    if nc < 3:
        nc = 1          # one cell: every reference point is a candidate
    rkey, rorder = torch.sort(_cell_keys(rpos, box, nc))
    offsets = [(0, 0, 0)] if nc == 1 else _OFFSETS
    step = max(1, WINDOWS // len(offsets))
    for q0 in range(0, qpos.shape[0], step):
        for qi, rj in _block_pairs(qpos[q0:q0 + step], rkey, rorder, box,
                                   nc, offsets, budget):
            yield qi + q0, rj


def _block_pairs(qpos, rkey, rorder, box: float, nc: int, offsets,
                 budget: int):
    """``neighbour_pairs`` of one block of query points."""
    dev = qpos.device
    qc = _cells(qpos, box, nc)
    starts, counts = [], []
    for dx, dy, dz in offsets:
        x = torch.remainder(qc[:, 0] + dx, nc)
        y = torch.remainder(qc[:, 1] + dy, nc)
        z = torch.remainder(qc[:, 2] + dz, nc)
        key = (x * nc + y) * nc + z
        s = torch.searchsorted(rkey, key)
        starts.append(s)
        counts.append(torch.searchsorted(rkey, key, right=True) - s)
    start = torch.stack(starts, 1).reshape(-1)
    count = torch.stack(counts, 1).reshape(-1)
    nwin = len(offsets)
    csum = torch.cumsum(count, 0)
    total = int(csum[-1]) if csum.numel() else 0
    done = 0
    while done < total:
        # whole windows up to the budget (a longer window alone)
        w0 = int(torch.searchsorted(csum, done, right=True))
        w1 = int(torch.searchsorted(csum, done + budget, right=True))
        w1 = max(w1, w0 + 1)
        end = int(csum[w1 - 1])
        t = torch.arange(done, end, device=dev)
        k = torch.searchsorted(csum[w0:w1], t, right=True) + w0
        first = csum[k] - count[k]
        ridx = rorder[start[k] + (t - first)]
        yield k // nwin, ridx
        done = end


def min_image(d: torch.Tensor, box: float) -> torch.Tensor:
    return d - box * torch.round(d / box)


def dist2(a: torch.Tensor, b: torch.Tensor, box: float) -> torch.Tensor:
    """Squared minimum-image distances of matching rows, float64."""
    d = min_image(a.double() - b.double(), box)
    return (d * d).sum(1)
