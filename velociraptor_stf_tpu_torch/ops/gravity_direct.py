"""Direct-sum group potential over group-sorted particles (port of
velociraptor_stf_tpu/ops/pallas_gravity.py::potential_group_sorted).

Every row carries its group's slot range ``[offsets[g], offsets[g+1])``:
the particles are sorted by group, so its partners are exactly that range
minus itself.  Rows of gid 0 (untagged, or groups left to the tree) get the
empty range (0, 0).  The kernel (``kernels/potential.py``) takes the union
of a row block's ranges as the block's column span, so zero-gid runs
neither widen a mixed block's span nor drag its start down.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import potential as K


def block_window(gid_s: torch.Tensor, offsets: torch.Tensor,
                 ends: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(ns, 2) int32 slot range [start, end) of the group of every row of
    the group-sorted ``gid_s`` (the windows from which the kernel's row
    blocks take their column spans); (0, 0) for gid 0.  ``offsets`` is the
    (ng+2,) group slice table; ``ends``: each group's end where padding
    rows (gid 0) lie between the groups (default ``offsets[g + 1]``)."""
    g = gid_s.long()
    tagged = g > 0
    start = torch.where(tagged, offsets[g], 0)
    end_of = offsets[1:] if ends is None else ends
    end = torch.where(tagged, end_of[g], 0)
    return torch.stack([start, end], 1).to(torch.int32).contiguous()


def potential_group_sorted(pos_s: torch.Tensor, mass_s: torch.Tensor,
                           gid_s: torch.Tensor, offsets: torch.Tensor,
                           eps2: float,
                           ends: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Phi_i = sum over j != i in group(i) of m_j / sqrt(d^2 + eps2) for
    group-sorted (ns, 3) positions; gid 0 is skipped.  ``offsets`` is the
    (ng+2,) group slice table (group g occupies [offsets[g],
    offsets[g+1]), or [offsets[g], ends[g]) given ``ends``).  Returns
    (ns,) float32 Phi, unscaled (the caller multiplies by -G).  The kernel
    works in float32, as the reference's does."""
    return K.potential(pos_s.T.to(torch.float32).contiguous(),
                       mass_s.to(torch.float32).contiguous(),
                       gid_s.to(torch.int32).contiguous(),
                       block_window(gid_s, offsets, ends), eps2)
