"""The metric stages of the pipeline: field search + field unbinding (port
of the stages of velociraptor_stf_tpu/models/pipeline.py::find_structures
that ``bench.py`` times).

``search_and_unbind`` runs the cosmology set-up, the 3DFOF/6DFOF field
search, the iKeepFOF envelope split and, with ``iBoundHalos >= 1``, the
field-halo unbind; it times the "fof" and "unbind" stages as the reference
does.  Properties, SO, substructure, baryons, single-halo mode and a device
mesh are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Union

import numpy as np
import torch

from . import halos, unbind

from velociraptor_stf_tpu.utils import config as C
from velociraptor_stf_tpu.utils import units


@dataclass
class SearchResult:
    pfof: torch.Tensor                  # final group id per particle
    ngroups: int
    W: Optional[torch.Tensor] = None    # potential energies (if unbound)
    pfof3d: Optional[torch.Tensor] = None   # 3DFOF ids when 6D ran
    timings: Dict[str, float] = field(default_factory=dict)


def _as_f32(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def search_and_unbind(opt: C.Options, pos, vel, mass,
                      boxsize: Optional[float] = None,
                      device: Union[str, torch.device] = "cuda",
                      ptype=None, mesh=None) -> SearchResult:
    """Field search [+ field unbind] of (N, 3) positions and velocities and
    (N,) masses (numpy or tensors; computed in float32 on ``device``).
    ``boxsize > 0`` makes the box periodic."""
    if mesh is not None:
        raise NotImplementedError("a device mesh is not ported yet")
    if opt.iSingleHalo:
        raise NotImplementedError("iSingleHalo is not ported yet")
    if opt.iSubSearch:
        raise NotImplementedError("substructure search (iSubSearch) is not "
                                  "ported yet")
    if ptype is not None and opt.iBaryonSearch > 0:
        types = np.unique(np.asarray(ptype))
        if C.DARKTYPE in types and len(types) > 1:
            raise NotImplementedError("baryon mode is not ported yet")
    device = torch.device(device)
    on_gpu = device.type == "cuda"

    def clock() -> float:
        if on_gpu:
            torch.cuda.synchronize(device)
        return time.perf_counter()

    timings: Dict[str, float] = {}
    units.calc_cosmo_params(opt, opt.a)
    pos, vel, mass = (_as_f32(a, device) for a in (pos, vel, mass))

    t0 = clock()
    fres = halos.search_full_set(opt, pos, vel, mass, boxsize=boxsize)
    pfof, ng = fres.pfof, fres.ngroups
    timings["fof"] = clock() - t0
    pfof3d = fres.pfof3d

    # iKeepFOF: the 3DFOF envelopes are split off (never unbound) and
    # re-attached as ids 1..keepfof afterwards
    keepfof = fres.num3dfof
    env_pfof = None
    if keepfof > 0:
        env_pfof = torch.where(pfof <= keepfof, pfof, 0)
        pfof = torch.where(pfof > keepfof, pfof - keepfof, 0)
        ng -= keepfof

    W = None
    if opt.uinfo.unbindflag and ng > 0 and opt.iBoundHalos >= 1:
        t0 = clock()
        minsize = opt.HaloMinSize if opt.HaloMinSize > 0 else opt.MinSize
        ures = unbind.check_unbound_groups(pos, vel, mass, pfof, ng,
                                           opt.uinfo, opt.G, boxsize=boxsize,
                                           min_size=minsize)
        pfof, ng, W = ures.pfof, ures.ngroups, ures.W
        timings["unbind"] = clock() - t0

    if keepfof > 0:
        pfof = torch.where(pfof > 0, pfof + keepfof, env_pfof)
        ng += keepfof
    return SearchResult(pfof=pfof, ngroups=ng, W=W, pfof3d=pfof3d,
                        timings=timings)
