"""Baryon association over a mesh (port of
velociraptor_stf_tpu/parallel/distributed_baryons.py), the analog of the
reference's MPI baryon export (mpiroutines.cxx:2170-3031: tagged DM near
a rank's boundary is exported so that each rank assigns its own baryons,
search.cxx:3201+).

The tagged DM and the baryons together take the slab plan of the
distributed FOF (``parallel/distributed_fof.py::SlabPlan``), with cells
at least the association's spatial reach wide; the tagged DM of each
shard's boundary columns rides the ghost exchange, and each shard assigns
its own baryons with ``ops/fof.py::nearest_assign_points`` over its tagged
DM and the ghosts: the metric, the grid and the tie-break of
``models/baryons.py``, so every baryon gets the group it gets on one
device.
"""

from __future__ import annotations

import torch

from ..ops import fof
from ..utils import telemetry
from . import collectives as col
from .distributed_fof import SlabPlan
from .mesh import Mesh


@col.staged("baryons")
def distributed_baryon_assign(pos_d: torch.Tensor, vel_d: torch.Tensor,
                              grp_d: torch.Tensor, pos_b: torch.Tensor,
                              vel_b: torch.Tensor, ellx: float, mesh: Mesh,
                              boxsize: float, metric) -> torch.Tensor:
    """(nb,) int32 group of each baryon (0 = unassigned) on the home
    device, from the tagged DM (``pos_d``, ``vel_d``, groups ``grp_d``
    > 0) and the baryons (``pos_b``, ``vel_b``), all on the home device;
    ``metric`` is ``models/baryons.py::PhaseMetric``, whose spatial reach
    is ``ellx``."""
    nd, nb = int(pos_d.shape[0]), int(pos_b.shape[0])
    plan = SlabPlan(torch.cat([pos_d, pos_b]), ellx, boxsize, mesh)
    dev_grp = plan.pack(torch.cat([grp_d.long(), torch.zeros(
        nb, dtype=torch.int64, device=grp_d.device)]))
    fields = [[p, g, v, r] for p, g, v, r in zip(
        plan.pos_b, plan.gid_b, plan.pack(torch.cat([vel_d, vel_b])),
        dev_grp)]
    # only tagged DM serves as a candidate: only it travels
    shards = plan.with_ghosts(fields, travel=[r > 0 for r in dev_grp])
    out = []
    for (sel, _, _, cf), gid_l in zip(shards, plan.gid_b):
        m = int(sel.shape[0])
        isb = gid_l >= nd
        dm = torch.nonzero(cf[3] > 0).squeeze(1)
        one = torch.ones((), dtype=torch.int32, device=gid_l.device)
        grp, _, pairs = fof.nearest_assign_points(
            cf[0][:m][isb], {"vel": cf[2][:m][isb], "isb": one}, cf[0][dm],
            {"vel": cf[2][dm], "isb": one * 0}, cf[3][dm], ellx, boxsize,
            metric)
        telemetry.count("baryon_pairs", pairs)
        lab = torch.zeros_like(gid_l, dtype=torch.int32)
        lab[isb] = grp
        out.append(lab)
    grp_all = plan.unpack(out)
    return grp_all[nd:]
