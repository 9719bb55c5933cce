"""Baryon association with dark-matter structures (port of
velociraptor_stf_tpu/models/baryons.py; reference ``SearchBaryons``,
search.cxx:3053-3588).

After the DM-only structure search every gas, star and black-hole particle
joins the group of its phase-space-nearest tagged DM particle, provided
that particle lies inside the scaled linking ellipse (:3201+); equal
distances go to the lowest group id.  The caller then unbinds the groups
again with the baryons attached.

Only tagged DM can win an assignment (the reference builds its tree over
the particles in groups, search.cxx:3150), and only baryons need one, so
the pair pass has baryon rows and tagged-DM columns only and streams them
in batches (``ops/fof.py::nearest_assign_points``); the combined edge list
of the reference is never formed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops import fof
from ..ops import segments as seg
from ..utils import config as C
from ..utils import telemetry


@dataclasses.dataclass(frozen=True)
class PhaseMetric:
    """Phase-space distance dx^2/ellx^2 + dv^2/ellv^2; eligible pairs are
    (baryon assignee, DM candidate) inside the unit ellipse."""

    ellx2: float
    ellv2: float

    def __call__(self, d2, own, nbr):
        dv2 = seg.sq3(own["vel"] - nbr["vel"])
        dist = d2 / self.ellx2 + dv2 / self.ellv2
        elig = (own["isb"] > 0) & (nbr["isb"] == 0) & (dist <= 1.0)
        return dist, elig


@dataclasses.dataclass(frozen=True)
class _PairInRange:
    """Symmetric edge eligibility: exactly one of the pair is a baryon and
    the pair lies inside the phase-space ellipse."""

    ellx2: float
    ellv2: float
    symmetric = True

    def __call__(self, d2, own, nbr):
        dv2 = seg.sq3(own["vel"] - nbr["vel"])
        dist = d2 / self.ellx2 + dv2 / self.ellv2
        return (own["isb"] != nbr["isb"]) & (dist <= 1.0)


def velocity_scale2(vel_dm: torch.Tensor, pfof_dm: torch.Tensor) -> float:
    """The tagged DM's velocity dispersion^2 about its mean (unweighted),
    summed in the velocities' dtype as the reference sums it."""
    w = (pfof_dm > 0).to(vel_dm.dtype)
    mt = torch.clamp_min(w.sum(), 1.0)
    vm = (vel_dm * w[:, None]).sum(0) / mt
    return float((((vel_dm - vm) ** 2).sum(-1) * w).sum() / mt)


def search_baryons(opt: C.Options, pos_dm: torch.Tensor,
                   vel_dm: torch.Tensor, pfof_dm: torch.Tensor,
                   pos_b: torch.Tensor, vel_b: torch.Tensor,
                   boxsize: Optional[float] = None,
                   vscale2: Optional[float] = None,
                   mesh=None) -> torch.Tensor:
    """Assign baryons to DM groups: (Nb,) int32 group ids, 0 = unassigned.

    Linking length: ``ellphys * ellxscale * ellhalophysfac``; velocity
    scale^2: ``vscale2`` (``opt.HaloVelDispScale`` when set, else the
    tagged DM's dispersion) times ``ellhalovelfac``^2.  The pairs the
    pass enumerated are counted as ``baryon_pairs`` (utils/telemetry).
    With ``mesh`` and a periodic box each shard assigns the baryons of
    its slab (``parallel/distributed_baryons.py``)."""
    nb = pos_b.shape[0]
    ellx = opt.ellphys * opt.ellxscale * opt.ellhalophysfac
    if vscale2 is None:
        vscale2 = opt.HaloVelDispScale if opt.HaloVelDispScale > 0 else \
            velocity_scale2(vel_dm, pfof_dm)
    ellv2 = max(vscale2, 1e-30) * opt.ellhalovelfac ** 2

    didx = torch.nonzero(pfof_dm > 0).squeeze(1)
    if didx.shape[0] == 0 or nb == 0:
        return torch.zeros(nb, dtype=torch.int32, device=pos_b.device)
    metric = PhaseMetric(float(ellx * ellx), float(ellv2))
    if mesh is not None and boxsize:
        from ..parallel.distributed_baryons import distributed_baryon_assign

        return distributed_baryon_assign(
            pos_dm[didx], vel_dm[didx], pfof_dm[didx], pos_b, vel_b,
            float(ellx), mesh, float(boxsize), metric)
    # every row is a baryon and every column DM: 0-d fields
    one = torch.ones((), dtype=torch.int32, device=pos_b.device)
    grp, _, pairs = fof.nearest_assign_points(
        pos_b, {"vel": vel_b, "isb": one}, pos_dm[didx],
        {"vel": vel_dm[didx], "isb": one * 0}, pfof_dm[didx], ellx, boxsize,
        metric)
    telemetry.count("baryon_pairs", pairs)
    return grp
