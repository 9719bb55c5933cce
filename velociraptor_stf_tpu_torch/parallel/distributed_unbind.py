"""Unbinding over a mesh, whole groups per shard (port of
velociraptor_stf_tpu/parallel/distributed_unbind.py): the analog of the
reference's ``MPIGroupExchange`` followed by per-rank
``CheckUnboundGroups`` (mpiroutines.cxx:2548, unbind.cxx:196).

Groups are dealt whole to the shards (``parallel/grouppack.py``); each
shard computes its groups' potential with
``ops/gravity_direct.py::potential_group_sorted`` (the CUDA potential
kernel on a card) and runs ``models/unbind.py``'s ejection on its block:
the POTREF frame, ``maxunbindfrac``, and with ``Keep_background_potential
= 0`` the potential recomputed between chunks.  The shards step their
ejections in lockstep (``unbind.run_ejections``), so the per-group sums
start afresh at the chunks where the single-device run compacts its
working set, decided on the sum of the shards' selections: each group
goes through the same iterations as on one device.  The bound masks and
potentials come back to the home device, where ``_finalize`` dissolves
and renumbers as on one device.

The potential's float32 partial sums run over column tiles at multiples
of ``kernels/potential.py::TILE``, so a shard lays each group out at its
single-device offset modulo ``TILE`` (zero-mass padding rows of gid 0
between groups): the initial potentials are those of one device, bit for
bit.  The recomputes of ``Keep_background_potential = 0`` take the
shard's own layout and can differ from one device in the last bit.

As in the JAX package, the mesh unbind sums every group's potential
directly: no group goes to the bucket tree, whatever its size (the
single-device run takes the tree above ``unbind.MAX_DIRECT`` members).
No fallback exists: a kernel that fails on a shard raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..kernels.potential import TILE
from ..models import unbind
from ..ops import gravity_direct, segments as seg
from ..utils.config import UnbindInfo
from . import collectives as col
from ..utils.transfer import fetch_small
from .grouppack import plan_group_blocks
from .mesh import Mesh

_NO_TREE = 1 << 62


def _aligned_potential(pos: torch.Tensor, mass: torch.Tensor,
                       gid: torch.Tensor, sizes: np.ndarray,
                       offset_mod: np.ndarray, eps: float, G: float,
                       boxsize: Optional[float]) -> torch.Tensor:
    """W = m Phi of one shard's group-sorted rows (local ids 1..k,
    ``sizes`` (k+1,)), each group laid out at the offset ``offset_mod[g]``
    modulo ``TILE`` that it has on one device."""
    dev = pos.device
    k = len(sizes) - 1
    if boxsize:
        pos = seg.unwrap_positions(pos, gid, boxsize, k)
    start = np.zeros(k + 2, np.int64)
    ends = np.zeros(k + 1, np.int64)
    cur = 0
    for g in range(1, k + 1):
        start[g] = cur + (int(offset_mod[g]) - cur) % TILE
        cur = ends[g] = start[g] + sizes[g]
    first = np.concatenate([[0], np.cumsum(sizes[1:])])    # in the rows
    slot = torch.arange(pos.shape[0], device=dev) + torch.from_numpy(
        start[1:k + 1] - first[:k]).to(dev)[gid - 1]
    ns = int(cur)
    pos_p = torch.zeros(ns, 3, dtype=torch.float32, device=dev)
    mass_p = torch.zeros(ns, dtype=torch.float32, device=dev)
    gid_p = torch.zeros(ns, dtype=torch.int64, device=dev)
    pos_p[slot], mass_p[slot], gid_p[slot] = pos.float(), mass.float(), gid
    phi = gravity_direct.potential_group_sorted(
        pos_p, mass_p, gid_p, torch.from_numpy(start).to(dev),
        float(eps * eps), ends=torch.from_numpy(ends).to(dev))
    return ((-G) * phi[slot]).to(pos.dtype) * mass


@col.staged("unbind")
def distributed_unbind(pos: torch.Tensor, vel: torch.Tensor,
                       mass: torch.Tensor, pfof: torch.Tensor,
                       num_groups: int, uinfo: UnbindInfo, G: float,
                       mesh: Mesh, boxsize: Optional[float] = None,
                       min_size: int = 20) -> unbind.UnbindResult:
    """``unbind.check_unbound_groups`` over the mesh: the same bound
    sets, dissolution and renumbering.  Whole arrays on ``mesh.home``."""
    n = int(pfof.shape[0])
    pfof = pfof.long()
    sizes = fetch_small(torch.bincount(pfof, minlength=num_groups + 1))
    sizes[0] = 0
    plan = plan_group_blocks(pfof, num_groups, mesh, sizes=sizes,
                             stage="unbind")
    bound = torch.zeros(n, dtype=torch.bool, device=pfof.device)
    W = torch.zeros(n, dtype=pos.dtype, device=pos.device)
    if plan is not None:
        # each group's offset among the tagged rows on one device
        offset = np.cumsum(sizes) - sizes
        pos_b, vel_b, mass_b = (plan.pack(a) for a in (pos, vel, mass))
        gid_b = plan.pack_local_gids(pfof)
        blocks = []
        for p, v, m, g, gl in zip(pos_b, vel_b, mass_b, gid_b, plan.gids):
            W_l = _aligned_potential(p, m, g, sizes[gl], offset[gl] % TILE,
                                     uinfo.eps, G, boxsize) \
                if len(gl) > 1 else torch.zeros_like(m)
            blocks.append(unbind.Ejection(p, v, m, g, W_l, len(gl) - 1,
                                          uinfo, G, boxsize, min_size,
                                          direct_cut=_NO_TREE))
        W = plan.unpack([e.W_init for e in blocks], fill=0.0)
        ntag = int(sizes.sum())
        ncur = seg.pad_class(ntag) if 0 < ntag < n // 2 else n
        # a shard without groups has nothing to eject
        unbind.run_ejections([e for e, k in zip(blocks, plan.ng_loc) if k],
                             ncur)
        bound = plan.unpack([e.bound_out for e in blocks], fill=False)
    tagged = torch.nonzero(pfof > 0).squeeze(1)
    order = tagged[torch.argsort(pfof[tagged], stable=True)]
    return unbind._finalize(pfof, bound, W, num_groups, uinfo, min_size,
                            (mass[order], pfof[order], bound[order]))
