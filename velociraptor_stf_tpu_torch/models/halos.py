"""Field halo search: 3DFOF + 6DFOF refinement (port of
velociraptor_stf_tpu/models/halos.py, the sweep path of
``_search_full_set_pallas`` and ``_finish_6d``).

Stages: cell-sorted context over the particles and their periodic ghost
images -> detect pass keeping particles with a neighbour within the 3D
linking length -> 3D label fixed point on that linked subset -> velocity
scale(s) -> 6D fixed point on the 3DFOF-tagged subset.  Both prunes are
exact (a pair needs both ends kept; 6D links join only members of one
nonzero 3DFOF group), and the subsets are sized from exact counts, so no
capacity can overflow and no edge-pipeline fallback exists.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops import segments
from ..ops.fof_sweep import SweepFof

from velociraptor_stf_tpu.utils import config as C


@dataclass
class FieldSearchResult:
    pfof: torch.Tensor          # final group ids, original particle order
    ngroups: int
    pfof3d: Optional[torch.Tensor] = None   # 3DFOF labels if 6D ran
    ngroups3d: int = 0
    vscale2: Optional[torch.Tensor] = None  # per-particle 6D velocity scale
    # iKeepFOF: ids 1..num3dfof are the kept 3DFOF envelopes; ids
    # num3dfof+1.. are 6DFOF structures whose envelope is parent3d[gid]
    num3dfof: int = 0
    parent3d: Optional[torch.Tensor] = None


def velocity_scale_largest_group(vel: torch.Tensor, mass: torch.Tensor,
                                 pfof: torch.Tensor, num_segments: int,
                                 ellhalo6dvfac: float,
                                 bug_compat: bool = False) -> torch.Tensor:
    """Mass-weighted velocity dispersion^2 of group 1 (the largest) times
    ellhalo6dvfac^2, as a 0-d tensor.  ``bug_compat`` reproduces the
    reference's stray-statement mass sum (search.cxx:450): the mass of the
    particle one past group 1 in sorted order."""
    sel = pfof == 1
    w = torch.where(sel, mass, 0.0)
    sv = (vel * w[:, None]).sum(0)
    if bug_compat:
        n = pfof.shape[0]
        ari = torch.arange(n, device=pfof.device)
        cand2 = int(torch.where(pfof == 2, ari, n).min())
        cand0 = int(torch.where(pfof == 0, ari, n).min())
        cand_last = int(torch.where(sel, ari, -1).max())
        idx = cand2 if cand2 < n else cand0 if cand0 < n else cand_last
        mtot = torch.clamp_min(mass[min(max(idx, 0), n - 1)], 1e-30)
    else:
        mtot = torch.clamp_min(w.sum(), 1e-30)
    vmean = sv / mtot
    dv2 = ((vel - vmean) ** 2).sum(-1)
    return (dv2 * w).sum() / mtot * ellhalo6dvfac ** 2


def velocity_scale_per_group(vel: torch.Tensor, mass: torch.Tensor,
                             pfof: torch.Tensor, num_segments: int,
                             ellhalo6dvfac: float) -> torch.Tensor:
    """(num_segments,) per-group mass-weighted velocity dispersion^2 times
    ellhalo6dvfac^2 (FOF6DADAPTIVE)."""
    vmean = segments.segment_mean(vel, mass, pfof, num_segments)
    dv2 = ((vel - vmean[pfof]) ** 2).sum(-1)
    return segments.segment_mean(dv2, mass, pfof, num_segments) * \
        ellhalo6dvfac ** 2


def velocity_scales(opt: C.Options, vel: torch.Tensor, mass: torch.Tensor,
                    pfof3: torch.Tensor, ng3: int) -> torch.Tensor:
    """Per-particle 6D velocity scale: one scale from the largest group
    (FOF6D) or each group's own (FOF6DADAPTIVE, and iKeepFOF); 1 for
    untagged particles."""
    if opt.fofbgtype == C.FOF6D and not opt.iKeepFOF:
        vs = velocity_scale_largest_group(
            vel, mass, pfof3, ng3 + 1, opt.ellhalo6dvfac,
            bug_compat=bool(opt.iVscaleReferenceBugCompat))
        return torch.where(pfof3 > 0, vs, 1.0)
    vs_group = velocity_scale_per_group(vel, mass, pfof3, ng3 + 1,
                                        opt.ellhalo6dvfac)
    return torch.where(pfof3 > 0, torch.clamp_min(vs_group[pfof3], 1e-30),
                       1.0)


def search_full_set(opt: C.Options, pos: torch.Tensor, vel: torch.Tensor,
                    mass: torch.Tensor, boxsize: Optional[float] = None
                    ) -> FieldSearchResult:
    """Find field halos in (N, 3) positions / velocities and (N,) masses
    (float32, all on one device); group ids in original particle order.
    A periodic box has ``boxsize > 0``."""
    minsize = opt.HaloMinSize if opt.HaloMinSize > 0 else opt.MinSize
    b3d = opt.ellphys * opt.ellxscale * opt.ellhalophysfac
    run6d = opt.fofbgtype in (C.FOF6D, C.FOF6DADAPTIVE)
    # one context serves both passes: cells span the larger linking length
    reach = b3d * max(1.0, opt.ellhalo6dxfac if run6d else 1.0)
    box = float(boxsize) if boxsize else None

    # each context is dropped once its subset exists (device memory)
    fof = SweepFof(pos, vel, box, reach)
    keep, _ = fof.linked_mask(b3d)
    fof3 = fof.subset(keep)
    del fof
    pfof3, ng3 = fof3.fof3d(b3d, minsize)
    if not (run6d and ng3 > 0):
        return FieldSearchResult(pfof=pfof3, ngroups=ng3)
    vs = velocity_scales(opt, vel, mass, pfof3, ng3)
    fof6 = fof3.subset(pfof3 > 0)
    del fof3
    pfof6, ng6 = fof6.fof6d(b3d * opt.ellhalo6dxfac, pfof3, vs, minsize)
    return finish_6d(opt, pfof3, ng3, pfof6, ng6, vs)


def finish_6d(opt: C.Options, pfof3: torch.Tensor, ng3: int,
              pfof6: torch.Tensor, ng6: int,
              vscale2: torch.Tensor) -> FieldSearchResult:
    """With iKeepFOF, keep the 3DFOF envelopes as parents of the 6D
    structures (reference search.cxx:582-655): an envelope survives when
    one of its particles is in no 6D group, and its members are exactly
    those particles."""
    if not opt.iKeepFOF:
        return FieldSearchResult(pfof=pfof6, ngroups=ng6, pfof3d=pfof3,
                                 ngroups3d=ng3, vscale2=vscale2)
    dev = pfof3.device
    in6 = pfof6 > 0
    has_free = torch.zeros(ng3 + 1, dtype=torch.bool, device=dev)
    has_free[pfof3[~in6 & (pfof3 > 0)]] = True
    num3dfof = int(has_free.sum())
    remap3 = torch.zeros(ng3 + 1, dtype=torch.int64, device=dev)
    remap3[has_free] = torch.arange(1, num3dfof + 1, device=dev)
    pfof = torch.where(in6, num3dfof + pfof6, remap3[pfof3])
    # envelope of each 6D group: its members' common 3D group
    parent3d = torch.zeros(num3dfof + ng6 + 1, dtype=torch.int64,
                           device=dev)
    first6 = torch.zeros(ng6 + 1, dtype=torch.int64, device=dev)
    first6.scatter_reduce_(0, pfof6[in6], remap3[pfof3[in6]], "amax")
    parent3d[num3dfof + 1:] = first6[1:]
    return FieldSearchResult(pfof=pfof, ngroups=num3dfof + ng6,
                             pfof3d=pfof3, ngroups3d=ng3, vscale2=vscale2,
                             num3dfof=num3dfof, parent3d=parent3d)
