"""Whole groups per shard (port of
velociraptor_stf_tpu/parallel/grouppack.py), shared by the sharded unbind
and property stages: the analog of the reference's ``MPIGroupExchange``
particle migration.

Groups are dealt to shards by serpentine LPT (``assign_groups_lpt``, a
copy of the JAX function: the same deal), and each shard's block holds its
groups' particles contiguously, in ascending global group id and, within
a group, in original order, with local ids 1..k.  The per-particle sort and
the gathers run on the device; the host sees the (ng+1,) group sizes and
the per-shard loads.  Blocks are exact: shard s holds load[s] rows, no
padding.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..utils import telemetry
from ..utils.transfer import fetch_small
from . import collectives as col
from .mesh import Mesh


def assign_groups_lpt(sizes: np.ndarray, ndev: int) -> np.ndarray:
    """(ng+1,) shard of each group: groups sorted largest first (ties by
    id) are dealt in serpentine rounds 0..ndev-1, ndev-1..0, ...; entry 0
    is ignored."""
    ng = len(sizes) - 1
    order = np.argsort(-sizes[1:], kind="stable") + 1
    k = np.arange(ng, dtype=np.int64)
    pos = k % ndev
    dev = np.where((k // ndev) % 2 == 0, pos, ndev - 1 - pos)
    dev_of = np.zeros(ng + 1, np.int32)
    dev_of[order] = dev.astype(np.int32)
    return dev_of


@dataclass
class GroupBlocks:
    """One group -> shard deal of a per-particle ``pfof`` on the home
    device."""

    mesh: Mesh
    n: int                    # particles of the whole array
    dev_of: np.ndarray        # (ng+1,) shard of each global gid
    gid_local: np.ndarray     # (ng+1,) local id 1..k_s of each global gid
    ng_loc: List[int]         # groups on each shard
    idx: List[torch.Tensor]   # per shard: original index of each row (home)
    stage: str = "grouppack"

    def pack(self, arr: torch.Tensor) -> List[torch.Tensor]:
        """Per-particle ``arr`` (on the home device) as shard blocks."""
        out = [col.move(arr[i], d)
               for i, d in zip(self.idx, self.mesh.devices)]
        col.count_reshard(self.stage, out)
        return out

    def pack_local_gids(self, pfof: torch.Tensor) -> List[torch.Tensor]:
        """Blocks of local group ids (1..k_s)."""
        gl = torch.from_numpy(self.gid_local).to(pfof.device)
        return self.pack(gl[pfof.long()].long())

    def unpack(self, blocks: List[torch.Tensor], fill=0,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Shard blocks back into one (n, ...) array in original order on
        the home device; particles of no group get ``fill``."""
        home = self.mesh.home
        dt = blocks[0].dtype if dtype is None else dtype
        out = torch.full((self.n,) + tuple(blocks[0].shape[1:]), fill,
                         dtype=dt, device=home)
        for i, b in zip(self.idx, blocks):
            out[i] = col.move(b, home).to(dt)
        col.count_reshard(self.stage, blocks)
        return out

    @property
    def gids(self) -> List[np.ndarray]:
        """Per shard, (k_s + 1,) global id of each local id (0 -> 0)."""
        out = []
        for s in range(self.mesh.size):
            g = np.nonzero((self.dev_of == s) & (self.gid_local > 0))[0]
            m = np.zeros(self.ng_loc[s] + 1, np.int64)
            m[self.gid_local[g]] = g
            out.append(m)
        return out


def plan_group_blocks(pfof: torch.Tensor, num_groups: int, mesh: Mesh,
                      sizes: Optional[np.ndarray] = None,
                      stage: str = "grouppack") -> Optional[GroupBlocks]:
    """The deal of the groups of ``pfof`` (on the home device), or None
    when no particle is tagged."""
    ndev = mesh.size
    n = int(pfof.shape[0])
    ng1 = num_groups + 1
    pfof = pfof.long()
    if sizes is None:
        sizes = fetch_small(torch.bincount(torch.clamp(pfof, 0, num_groups),
                                           minlength=ng1))
    sizes = np.asarray(sizes).astype(np.int64)
    sizes[0] = 0
    if sizes.sum() == 0:
        return None
    dev_of = assign_groups_lpt(sizes, ndev)
    # local ids in ascending global id order: each shard's groups come in
    # the order of the single-device run
    gsel = np.nonzero(sizes)[0]
    d_of = dev_of[gsel]
    gid_local = np.zeros(ng1, np.int64)
    ng_loc = []
    for s in range(ndev):
        mine = gsel[d_of == s]
        gid_local[mine] = np.arange(1, len(mine) + 1)
        ng_loc.append(len(mine))
    dev_t = torch.from_numpy(np.where(sizes > 0, dev_of, ndev)).to(
        pfof.device)
    # rows sorted by (shard, global gid), original order within a group
    key = dev_t[pfof] * ng1 + pfof
    order = torch.argsort(key, stable=True)
    load = fetch_small(torch.bincount(dev_t[pfof], minlength=ndev + 1))
    for s in range(ndev):
        telemetry.count(f"mesh_group_load::{stage}::shard{s}", load[s])
    starts = np.concatenate([[0], np.cumsum(load)])
    idx = [order[starts[s]:starts[s + 1]] for s in range(ndev)]
    return GroupBlocks(mesh=mesh, n=n, dev_of=dev_of, gid_local=gid_local,
                       ng_loc=ng_loc, idx=idx, stage=stage)
