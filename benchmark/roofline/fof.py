"""Work of the 3D FOF kernels (``detect_kernel``, ``sweep3d_kernel``),
counted by the benchmark from the inputs, and the card's peaks.

Every exact 3D search has to test at least the ordered pairs (i != j) of
particles within the linking length b, whatever grid or kernel does it,
and each test takes ``FOF_OPS_PER_PAIR`` lane operations (three
differences, three products, two sums, one compare).  A launch's least
time is the larger of those operations over the lane-issue rate and its
function's bytes (each input read once, each output written once) over
the memory bandwidth; the share is the launches' least times over their
kernel times, so it cannot pass 100%.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..reference.pairs import dist2, neighbour_pairs

# NVIDIA H100 SXM (data sheet): 132 SMs x 128 lanes at 1.98 GHz boost,
# 3.35 TB/s of HBM3; the power limit is recorded beside every share
LANE_OPS_PER_S = 132 * 128 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
FOF_OPS_PER_PAIR = 9


@dataclass
class FofWork:
    n: int            # particles searched (the detect pass's rows)
    n_linked: int     # particles with a neighbour within b (the sweeps')
    pairs: int        # ordered pairs within b

    def detect_bound_s(self) -> float:
        ops = self.pairs * FOF_OPS_PER_PAIR / LANE_OPS_PER_S
        # positions in (12 B), neighbour counts out (4 B)
        return max(ops, self.n * 16 / HBM_BYTES_PER_S)

    def sweep3d_bound_s(self) -> float:
        ops = self.pairs * FOF_OPS_PER_PAIR / LANE_OPS_PER_S
        # positions (12 B) and labels (4 B) in, labels out (4 B)
        return max(ops, self.n_linked * 20 / HBM_BYTES_PER_S)


def count(pos: torch.Tensor, b: float, box: float) -> FofWork:
    """Ordered pairs within ``b`` (minimum image) of ``pos`` and the
    particles that have one."""
    n = pos.shape[0]
    deg = torch.zeros(n, dtype=torch.int64, device=pos.device)
    b2 = float(b) * float(b)
    for qi, rj in neighbour_pairs(pos, pos, b, box):
        keep = qi != rj
        qi, rj = qi[keep], rj[keep]
        hit = dist2(pos[qi], pos[rj], box) <= b2
        deg += torch.bincount(qi[hit], minlength=n)
    return FofWork(n=n, n_linked=int((deg > 0).sum()),
                   pairs=int(deg.sum()))
