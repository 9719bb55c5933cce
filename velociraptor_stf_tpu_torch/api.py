"""Library-mode API: in-memory invocation from a simulation code (port of
velociraptor_stf_tpu/api.py).

Equivalent of the reference SWIFT interface
(swiftinterface.{h,cxx}): ``InitVelociraptor``:120 (one-time
config/unit/cosmology setup), ``InvokeVelociraptor``:273 (per-snapshot
in-memory particle search returning each particle's group assignment in
the caller's order), ``SetVelociraptorSimulationState``:206
(per-invocation cosmology/scale-factor update).

A simulation running on the same GPU hands its tensors over as they are --
no host round trip -- which replaces the reference's zero-copy
``swift_vel_part`` conversion.  The search runs on the device named by
``device`` (default ``"cuda"``, which needs a card: nothing falls back to
the CPU), sharded over a mesh in a periodic box when the CLI's
``_auto_mesh`` gives one (several cards, or ``VR_MESH``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch

from .io import writers
from .models import pipeline
from .particles import ParticleSet
from .utils import config as C
from .utils import units


@dataclass
class CosmoInfo:
    """Per-invocation cosmology state (reference cosmoinfo struct)."""

    atime: float = 1.0
    littleh: float = 1.0
    Omega_m: float = 0.3
    Omega_b: float = 0.0
    Omega_Lambda: float = 0.7
    Omega_r: float = 0.0
    w_de: float = -1.0


@dataclass
class SimInfo:
    """Per-invocation simulation state (reference siminfo struct)."""

    period: float = 0.0
    zoomhigresolutionmass: float = -1.0
    interparticlespacing: float = 1.0
    icosmologicalsim: int = 1


def _host(a) -> Optional[np.ndarray]:
    """``a`` as a numpy array on the host (the writers' and the type
    checks' side); None stays None."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return None if a is None else np.asarray(a)


class VelociraptorSession:
    """Init-once / invoke-per-snapshot session (InitVelociraptor +
    InvokeVelociraptor semantics)."""

    def __init__(self, config: Optional[str] = None,
                 config_text: Optional[str] = None,
                 opt: Optional[C.Options] = None):
        if opt is not None:
            self.opt = opt
        elif config is not None:
            self.opt = C.parse_config_file(config)
        elif config_text is not None:
            self.opt = C.parse_config_string(config_text)
        else:
            self.opt = C.Options()
        if self.opt.outname is None:
            self.opt.outname = "vrtpu_output"
        C.config_check(self.opt)

    def set_simulation_state(self, cosmo: CosmoInfo, sim: SimInfo):
        """Reference SetVelociraptorSimulationState (swiftinterface.cxx:206)."""
        o = self.opt
        o.a = cosmo.atime
        o.h = cosmo.littleh
        o.Omega_m = cosmo.Omega_m
        o.Omega_b = cosmo.Omega_b
        o.Omega_cdm = cosmo.Omega_m - cosmo.Omega_b
        o.Omega_Lambda = cosmo.Omega_Lambda
        o.Omega_r = cosmo.Omega_r
        o.w_de = cosmo.w_de
        o.p = sim.period
        o.ellxscale = sim.interparticlespacing
        o.icosmologicalin = sim.icosmologicalsim
        units.calc_cosmo_params(o, o.a)

    def invoke(self, pos, vel=None, mass=None, pids=None, ptype=None,
               cosmo: Optional[CosmoInfo] = None,
               sim: Optional[SimInfo] = None,
               snapnum: int = 0,
               outname: Optional[str] = None,
               extras: Optional[Dict] = None,
               write_output: bool = False,
               device: Union[str, torch.device] = "cuda"
               ) -> Dict[str, np.ndarray]:
        """Run the finder on in-memory particles (numpy arrays, or tensors
        on any device: those already on ``device`` are used where they
        lie); returns a dict with ``group_id`` in the caller's particle
        order (0 = unassigned) plus the property arrays -- the reference
        returns groupinfo{index, groupid}[] to SWIFT (swiftinterface.h:120)
        -- and ``timings``, the catalog's stage times in seconds
        (``find_structures``' ``timings``).

        ``pos`` may be a :class:`~velociraptor_stf_tpu_torch.particles.
        ParticleSet` (the in-memory analog of the reference's
        swift_vel_part conversion, swiftinterface.cxx:345-380) -- its
        fields then supply vel/mass/pids/ptype and the hydro extras.
        """
        if isinstance(pos, ParticleSet):
            ps = pos
            pos, vel, mass = ps.pos, ps.vel, ps.masses()
            pids = ps.pid if pids is None else pids
            ptype = ps.ptype if ptype is None else ptype
            if extras is None:
                extras = {k: getattr(ps, k) for k in
                          ("u", "sfr", "zmet", "tage")
                          if getattr(ps, k) is not None}
        if cosmo is not None or sim is not None:
            self.set_simulation_state(cosmo or CosmoInfo(), sim or SimInfo())
        opt = self.opt
        opt.snapshotvalue = snapnum
        boxsize = opt.p if opt.p > 0 else None
        # ids and types are read on the host only: by the mode checks and
        # the catalog writers
        pids, ptype = _host(pids), _host(ptype)
        # sharded when the CLI would be (``cli._auto_mesh``), in a
        # periodic box
        from .cli import _auto_mesh

        res = pipeline.find_structures(opt, pos, vel, mass, boxsize=boxsize,
                                       ptype=ptype, extras=extras,
                                       device=device,
                                       mesh=_auto_mesh(device) if boxsize
                                       else None)
        out = {
            "group_id": res.pfof,
            "ngroups": res.ngroups,
            "properties": res.props,
            "hostid": res.hostid,
            "parent": res.parent,
            "timings": res.timings,
        }
        if write_output:
            name = outname or f"{opt.outname}.{snapnum:04d}"
            cols = writers.properties_table(opt, res.props, res.ngroups,
                                            hostid=res.hostid)
            writers.write_properties(opt, name, cols, res.ngroups)
            if pids is not None:
                writers.write_group_catalog(opt, name, res.pfof, pids,
                                            res.ngroups, ptype=ptype)
                if opt.iextendedoutput:
                    # reference swiftinterface.cxx:505 WriteExtendedOutput
                    writers.write_extended_output(
                        opt, name, pids, res.pfof, hostid=res.hostid,
                        stype=res.stype)
        return out


def init_velociraptor(config: str, unitinfo=None, siminfo=None,
                      numthreads: int = 1) -> VelociraptorSession:
    """Reference InitVelociraptor-compatible constructor."""
    return VelociraptorSession(config=config)


def invoke_velociraptor(session: VelociraptorSession, snapnum, outname,
                        cosmoinfo, siminfo, npart_gravity, pos, vel, mass,
                        pids=None, ptype=None,
                        device: Union[str, torch.device] = "cuda"):
    """Reference InvokeVelociraptor-compatible wrapper."""
    return session.invoke(pos, vel, mass, pids=pids, ptype=ptype,
                          cosmo=cosmoinfo, sim=siminfo, snapnum=snapnum,
                          outname=outname, write_output=outname is not None,
                          device=device)
