"""Group properties over a mesh (port of
velociraptor_stf_tpu/parallel/distributed_props.py).

``distributed_bulk_properties``: the reductions that scale with the full
particle count (mass, centre of mass, its velocity, size, velocity
dispersion tensor, angular momentum), from the shards' partial per-group
sums combined by psum in two rounds (sums, then moments about the
centre), as the reference's per-rank GetProperties partial sums and group
allreduces do (mpiroutines.cxx:3240).  Sums are float64.

``distributed_properties``: the whole property stage with groups dealt
whole to the shards (``parallel/grouppack.py``, the deal of the sharded
unbind): each shard runs ``models/properties.py::property_bundle`` on its
block, and the per-group rows come back to the host by global id (the
reference's per-rank GetProperties after MPIGroupExchange,
substructureproperties.cxx:266).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import segments as seg
from ..utils.transfer import fetch_small
from . import collectives as col
from .mesh import Mesh


def chunks(mesh: Mesh, stage: str, *arrays: torch.Tensor
           ) -> List[List[torch.Tensor]]:
    """Per-particle arrays (home device) cut into ``mesh.size``
    contiguous blocks, one per shard."""
    bounds = np.linspace(0, int(arrays[0].shape[0]),
                         mesh.size + 1).astype(np.int64)
    out = [[col.move(a[bounds[s]:bounds[s + 1]], d) for a in arrays]
           for s, d in enumerate(mesh.devices)]
    col.count_reshard(stage, [a for blk in out for a in blk])
    return out


@col.staged("props")
def distributed_bulk_properties(pos: torch.Tensor, vel: torch.Tensor,
                                mass: torch.Tensor, pfof: torch.Tensor,
                                num_groups: int, mesh: Mesh,
                                boxsize: Optional[float] = None
                                ) -> Dict[str, np.ndarray]:
    """(ng+1,)-indexed bulk properties as numpy: num, gmass, gcm, gcmvel,
    gsize, gveldisp (3x3), gJ (about the CM, in the CM-velocity frame),
    gsigma_v.  A periodic box unwraps each group about its lowest-index
    member (found by a pmin over the shards)."""
    n = int(pos.shape[0])
    ng1 = num_groups + 1
    blocks = chunks(mesh, "props", pos.double(), vel.double(),
                    mass.double(), pfof.long(),
                    torch.arange(n, device=pos.device))

    g_b = [b[3] for b in blocks]
    num = col.psum(mesh, [torch.bincount(g, weights=(g > 0).double(),
                                         minlength=ng1).long()
                          for g in g_b])[0]
    w_b = [torch.where(g > 0, b[2], 0.0) for g, b in zip(g_b, blocks)]
    gmass = col.psum(mesh, [seg.segment_sum(w, g, ng1)
                            for w, g in zip(w_b, g_b)])[0]
    p_b = [b[0] for b in blocks]
    if boxsize:
        big = torch.iinfo(torch.int64).max
        first = col.pmin(mesh, [seg.segment_min(
            torch.where(g > 0, b[4], big), g, ng1)
            for g, b in zip(g_b, blocks)])
        ref = col.psum(mesh, [seg.segment_sum(
            torch.where(((b[4] == f[g]) & (g > 0))[:, None], b[0], 0.0), g,
            ng1) for g, b, f in zip(g_b, blocks, first)])
        p_b = []
        for g, b, r in zip(g_b, blocks, ref):
            d = b[0] - r[g]
            p_b.append(torch.where((g > 0)[:, None], r[g] + d - boxsize *
                                   torch.round(d / boxsize), b[0]))
    msafe = torch.clamp_min(gmass, 1e-30)[:, None]
    gcm = col.psum(mesh, [seg.segment_sum(w[:, None] * p, g, ng1)
                          for w, p, g in zip(w_b, p_b, g_b)])[0] / msafe
    gcmvel = col.psum(mesh, [seg.segment_sum(w[:, None] * b[1], g, ng1)
                             for w, b, g in zip(w_b, blocks, g_b)])[0] / msafe
    dx_b = [p - col.move(gcm, p.device)[g] for p, g in zip(p_b, g_b)]
    dv_b = [b[1] - col.move(gcmvel, b[1].device)[g]
            for b, g in zip(blocks, g_b)]
    r2max = col.pmax(mesh, [seg.segment_max(
        torch.where(g > 0, seg.sq3(dx), 0.0), g, ng1)
        for dx, g in zip(dx_b, g_b)])[0]
    gsize = torch.sqrt(torch.clamp_min(r2max, 0.0))
    disp = col.psum(mesh, [seg.segment_outer(dv, dv, w, g, ng1) for dv, w, g
                           in zip(dv_b, w_b, g_b)])[0] / msafe[..., None]
    J = col.psum(mesh, [seg.segment_sum(
        w[:, None] * torch.linalg.cross(dx, dv), g, ng1)
        for dx, dv, w, g in zip(dx_b, dv_b, w_b, g_b)])[0]
    sig = torch.sqrt(torch.clamp_min(
        torch.diagonal(disp, dim1=-2, dim2=-1).sum(-1) / 3.0, 0.0))
    out = dict(num=num, gmass=gmass, gcm=gcm, gcmvel=gcmvel, gsize=gsize,
               gveldisp=disp, gJ=J, gsigma_v=sig)
    return fetch_small(out)


@col.staged("props")
def distributed_properties(opt, pos: torch.Tensor, vel: torch.Tensor,
                           mass: torch.Tensor, pfof: torch.Tensor,
                           num_groups: int, mesh: Mesh, *, W=None,
                           ptype=None, boxsize: Optional[float] = None,
                           pertype: bool = False,
                           **hydro) -> Dict[str, np.ndarray]:
    """The property stage with whole groups per shard: numpy arrays
    indexed by global group id (rows 0..num_groups), the keys of
    ``property_bundle``.  Inputs are per particle on the home device;
    ``hydro`` holds the fields of ``properties.HYDRO_FIELDS``."""
    from ..models.properties import property_bundle
    from .grouppack import plan_group_blocks

    plan = plan_group_blocks(pfof, num_groups, mesh, stage="props")
    if plan is None:
        return {}
    pos_b, vel_b, mass_b = (plan.pack(a) for a in (pos, vel, mass))
    gid_b = plan.pack_local_gids(pfof)
    extra = {k: plan.pack(v) for k, v in
             dict(W=W, ptype=ptype, **hydro).items() if v is not None}
    gids = plan.gids
    # groups the unbind left without members are dealt to no shard; the
    # first shard with groups computes one more, memberless, group for
    # their rows, as one device computes them
    empty = np.nonzero(plan.gid_local[1:] == 0)[0] + 1
    res: Dict[str, np.ndarray] = {}
    for s in range(mesh.size):
        if plan.ng_loc[s] == 0:
            continue
        kw = {k: v[s] for k, v in extra.items()}
        extra_row = int(len(empty) > 0 and not res)
        pr = fetch_small(property_bundle(
            opt, pos_b[s], vel_b[s], mass_b[s], gid_b[s],
            plan.ng_loc[s] + extra_row, boxsize=boxsize, pertype=pertype,
            **kw))
        for k, v in pr.items():
            if k not in res:
                # row 0 (no members) as the first shard with groups
                # computes it
                res[k] = np.zeros((num_groups + 1,) + v.shape[1:], v.dtype)
                res[k][0] = v[0]
                if extra_row:
                    res[k][empty] = v[plan.ng_loc[s] + 1]
            res[k][gids[s][1:]] = v[1:plan.ng_loc[s] + 1]
    return res
