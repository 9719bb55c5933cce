"""Direct-sum group potential over group-sorted particles (port of
velociraptor_stf_tpu/ops/pallas_gravity.py::potential_group_sorted).

Each row block of ``R_BLOCK`` group-sorted slots interacts with one slot
window, ``[offsets[gmin], offsets[gmax+1])`` over the block's nonzero group
ids: every member of every group that has a row in the block.  Zero-gid
runs (untagged particles) neither empty a mixed block's window nor drag its
start down.  The kernel (``kernels/potential.py``) applies the exact
criterion: same nonzero gid, i != j.
"""

from __future__ import annotations

import torch

from ..kernels import R_BLOCK
from ..kernels import potential as K


def block_window(gid_s: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(nblocks, 1, 2) int32 (start, count) slot window of each row block
    of the group-sorted ``gid_s``; (0, 0) for a block of gid-0 rows."""
    ns = int(gid_s.shape[0])
    nblocks = -(-ns // R_BLOCK)
    g = torch.zeros(nblocks * R_BLOCK, dtype=torch.int64, device=gid_s.device)
    g[:ns] = gid_s
    g = g.view(nblocks, R_BLOCK)
    big = torch.iinfo(torch.int64).max
    gmin = torch.where(g > 0, g, big).amin(1)
    gmax = g.amax(1)
    has_rows = gmax > 0
    last = offsets.shape[0] - 1
    s = offsets[gmin.clamp(max=last)]
    e = offsets[(gmax + 1).clamp(max=last)]
    start = torch.where(has_rows, s, 0)
    count = torch.where(has_rows, e - s, 0)
    return torch.stack([start, count], -1).view(nblocks, 1, 2).to(torch.int32)


def potential_group_sorted(pos_s: torch.Tensor, mass_s: torch.Tensor,
                           gid_s: torch.Tensor, offsets: torch.Tensor,
                           eps2: float) -> torch.Tensor:
    """Phi_i = sum over j != i in group(i) of m_j / sqrt(d^2 + eps2) for
    group-sorted (ns, 3) positions; gid 0 is skipped.  ``offsets`` is the
    (ng+2,) group slice table (group g occupies [offsets[g],
    offsets[g+1])).  Returns (ns,) float32 Phi, unscaled (the caller
    multiplies by -G).  The kernel works in float32, as the reference's
    does."""
    return K.potential(pos_s.T.to(torch.float32).contiguous(),
                       mass_s.to(torch.float32).contiguous(),
                       gid_s.to(torch.int32).contiguous(),
                       block_window(gid_s, offsets), eps2)
