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
from typing import Optional, Tuple

import torch

from ..ops import segments
from ..ops.fof_sweep import SweepFof
from ..utils import config as C


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


def _group_sums(values: torch.Tensor, pfof: torch.Tensor,
                ng1: int) -> torch.Tensor:
    """Per-group float64 sums; for one group (``ng1`` 2, ids 0 / 1) a
    masked sum, which needs no sort (row 0 is then left 0)."""
    if ng1 == 2:
        one = (pfof == 1).to(values.dtype)
        one = one[:, None] if values.dim() > 1 else one
        return torch.stack([torch.zeros_like(values[0]),
                            (values * one).sum(0)])
    return segments.segment_sum(values, pfof, ng1)


def group_moments(vel: torch.Tensor, w: torch.Tensor, pfof: torch.Tensor,
                  ng1: int) -> torch.Tensor:
    """(ng1, 4) float64 per-group sums of [w, w vx, w vy, w vz] (the
    products rounded in float32).  Float64 sums hardly depend on how the
    particles are split: a mesh adds its shards' partial sums
    (``parallel/distributed_fof.py``) to what one device gets, and the
    float32 results agree."""
    return _group_sums(torch.stack(
        [w, w * vel[:, 0], w * vel[:, 1], w * vel[:, 2]], 1).double(),
        pfof, ng1)


def group_spread(vel: torch.Tensor, w: torch.Tensor, pfof: torch.Tensor,
                 vmean: torch.Tensor, ng1: int) -> torch.Tensor:
    """(ng1,) float64 per-group sums of w |v - vmean[g]|^2 (the squared
    deviation rounded in float32)."""
    return _group_sums(
        w.double() * segments.sq3(vel - vmean[pfof]).double(), pfof, ng1)


def mean_from_moments(tot: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(msum float64, vmean float32) from ``group_moments``."""
    msum = torch.clamp_min(tot[:, 0], 1e-30)
    return msum, (tot[:, 1:] / msum[:, None]).float()


def group_dispersion2(vel: torch.Tensor, mass: torch.Tensor,
                      pfof: torch.Tensor, ng1: int) -> torch.Tensor:
    """(ng1,) float32 mass-weighted velocity dispersion^2 of every group
    about its mass-weighted mean velocity, summed in float64."""
    msum, vmean = mean_from_moments(group_moments(vel, mass, pfof, ng1))
    return (group_spread(vel, mass, pfof, vmean, ng1) / msum).float()


def velocity_scale_largest_group(vel: torch.Tensor, mass: torch.Tensor,
                                 pfof: torch.Tensor, num_segments: int,
                                 ellhalo6dvfac: float,
                                 bug_compat: bool = False) -> torch.Tensor:
    """Mass-weighted velocity dispersion^2 of group 1 (the largest) times
    ellhalo6dvfac^2, as a 0-d tensor.  ``bug_compat`` reproduces the
    reference's stray-statement mass sum (search.cxx:450): the mass of the
    particle one past group 1 in sorted order."""
    if not bug_compat:
        return group_dispersion2(vel, mass, (pfof == 1).long(), 2)[1] * \
            ellhalo6dvfac ** 2
    sel = pfof == 1
    w = torch.where(sel, mass, 0.0)
    sv = (vel * w[:, None]).sum(0)
    n = pfof.shape[0]
    ari = torch.arange(n, device=pfof.device)
    cand2 = int(torch.where(pfof == 2, ari, n).min())
    cand0 = int(torch.where(pfof == 0, ari, n).min())
    cand_last = int(torch.where(sel, ari, -1).max())
    idx = cand2 if cand2 < n else cand0 if cand0 < n else cand_last
    mtot = torch.clamp_min(mass[min(max(idx, 0), n - 1)], 1e-30)
    vmean = sv / mtot
    dv2 = ((vel - vmean) ** 2).sum(-1)
    return (dv2 * w).sum() / mtot * ellhalo6dvfac ** 2


def velocity_scale_per_group(vel: torch.Tensor, mass: torch.Tensor,
                             pfof: torch.Tensor, num_segments: int,
                             ellhalo6dvfac: float) -> torch.Tensor:
    """(num_segments,) per-group mass-weighted velocity dispersion^2 times
    ellhalo6dvfac^2 (FOF6DADAPTIVE)."""
    return group_dispersion2(vel, mass, pfof, num_segments) * \
        ellhalo6dvfac ** 2


def scale_groups(opt: C.Options, pfof3: torch.Tensor, ng3: int
                 ) -> Tuple[torch.Tensor, int]:
    """(labels, ng1): the groups whose dispersions the 6D scale needs,
    group 1 alone (FOF6D, labels 0 / 1) or every 3DFOF group."""
    if opt.fofbgtype == C.FOF6D and not opt.iKeepFOF:
        return (pfof3 == 1).long(), 2
    return pfof3, ng3 + 1


def scales_per_particle(opt: C.Options, sig2: torch.Tensor,
                        pfof3: torch.Tensor) -> torch.Tensor:
    """Per-particle 6D velocity scale from the (ng3+1,) dispersions^2
    ``sig2``: group 1's for all (FOF6D), or each group's own
    (FOF6DADAPTIVE, and iKeepFOF); 1 for untagged particles."""
    fac2 = opt.ellhalo6dvfac ** 2
    if opt.fofbgtype == C.FOF6D and not opt.iKeepFOF:
        return torch.where(pfof3 > 0, sig2[1] * fac2, 1.0)
    return torch.where(pfof3 > 0, torch.clamp_min(sig2[pfof3] * fac2, 1e-30),
                       1.0)


def velocity_scales(opt: C.Options, vel: torch.Tensor, mass: torch.Tensor,
                    pfof3: torch.Tensor, ng3: int) -> torch.Tensor:
    """Per-particle 6D velocity scale (``scales_per_particle``);
    ``iVscaleReferenceBugCompat`` takes the reference's stray mass sum."""
    if opt.fofbgtype == C.FOF6D and not opt.iKeepFOF and \
            opt.iVscaleReferenceBugCompat:
        vs = velocity_scale_largest_group(vel, mass, pfof3, ng3 + 1,
                                          opt.ellhalo6dvfac, bug_compat=True)
        return torch.where(pfof3 > 0, vs, 1.0)
    g, ng1 = scale_groups(opt, pfof3, ng3)
    return scales_per_particle(opt, group_dispersion2(vel, mass, g, ng1),
                               pfof3)


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


def search_full_set_sharded(opt: C.Options, pos: torch.Tensor,
                            vel: torch.Tensor, mass: torch.Tensor,
                            boxsize: float, mesh) -> FieldSearchResult:
    """``search_full_set`` over a mesh of shards (whole arrays on
    ``mesh.home``): the slab FOF with ghost exchange for the 3DFOF and
    6DFOF labels (``parallel/distributed_fof.py``), the velocity scales
    from the shards' partial sums; the same criteria, ids and iKeepFOF
    envelopes.  ``iVscaleReferenceBugCompat``'s stray mass depends on one
    particle, so that scale is computed on the home device."""
    from ..parallel import distributed_fof as dfof

    minsize = opt.HaloMinSize if opt.HaloMinSize > 0 else opt.MinSize
    b3d = opt.ellphys * opt.ellxscale * opt.ellhalophysfac
    run6d = opt.fofbgtype in (C.FOF6D, C.FOF6DADAPTIVE)
    # one plan serves both passes: cells span the larger linking length
    reach = b3d * max(1.0, opt.ellhalo6dxfac if run6d else 1.0)
    plan = dfof.SlabPlan(pos, reach, float(boxsize), mesh)
    pfof3, ng3 = dfof.distributed_fof3d(pos, b3d, float(boxsize), mesh,
                                        min_size=minsize, plan=plan)
    if not (run6d and ng3 > 0):
        return FieldSearchResult(pfof=pfof3, ngroups=ng3)
    if opt.fofbgtype == C.FOF6D and not opt.iKeepFOF and \
            opt.iVscaleReferenceBugCompat:
        vs = velocity_scales(opt, vel, mass, pfof3, ng3)
    else:
        g, ng1 = scale_groups(opt, pfof3, ng3)
        vs = scales_per_particle(opt, dfof.velocity_scales_sharded(
            plan, vel, mass, g, ng1 - 1), pfof3)
    pfof6, ng6 = dfof.distributed_fof3d(
        pos, b3d * opt.ellhalo6dxfac, float(boxsize), mesh,
        min_size=minsize, vel=vel, vscale2=vs, group=pfof3, plan=plan)
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
