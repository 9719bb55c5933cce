"""Particle data container (port of velociraptor_stf_tpu/particles.py).

Struct-of-arrays: one dense array per field, all sharing the leading
dimension N.  The fields may be torch tensors (on the CPU or already on the
card) or numpy arrays; ``take`` and ``masses`` keep the kind they find.
Fields mirror what the reference Particle carries (positions, velocities,
mass, PID, type, density = local velocity density, potential) plus
optional hydro extras (u, sfr, metallicity, stellar age).  The reference
registers the class as a JAX pytree; here it is a plain class.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

# particle type codes (gadget convention, cf. reference allvars.h GASTYPE..)
GAS = 0
DARK = 1
DARK2 = 2
DARK3 = 3
STAR = 4
BH = 5
WIND = 6
TRACER = 7

Array = Union[torch.Tensor, np.ndarray]


class ParticleSet:
    """Struct-of-arrays particle set.

    All arrays share leading dimension N.  ``mass`` may be a scalar
    broadcast (common for DM-only runs, cf. reference NOMASS option).
    """

    _array_fields = ("pos", "vel", "mass", "pid", "ptype", "density",
                     "potential", "u", "sfr", "zmet", "tage")

    def __init__(self, pos: Array, vel: Array, mass, pid=None, ptype=None,
                 density=None, potential=None, u=None, sfr=None, zmet=None,
                 tage=None):
        self.pos = pos
        self.vel = vel
        self.mass = mass
        n = pos.shape[0]
        if isinstance(pos, torch.Tensor):
            if pid is None:
                pid = torch.arange(n, dtype=torch.int32, device=pos.device)
            if ptype is None:
                ptype = torch.full((n,), DARK, dtype=torch.int8,
                                   device=pos.device)
        else:
            if pid is None:
                pid = np.arange(n, dtype=np.int32)
            if ptype is None:
                ptype = np.full(n, DARK, dtype=np.int8)
        self.pid = pid
        self.ptype = ptype
        self.density = density
        self.potential = potential
        self.u = u
        self.sfr = sfr
        self.zmet = zmet
        self.tage = tage

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    def masses(self) -> Array:
        """Per-particle masses as an (N,) array regardless of storage."""
        m = self.mass
        if isinstance(m, torch.Tensor):
            return m.expand(self.n) if m.dim() == 0 else m
        m = np.asarray(m)
        if m.ndim > 0:
            return m
        if isinstance(self.pos, torch.Tensor):
            return torch.full((self.n,), float(m), dtype=self.pos.dtype,
                              device=self.pos.device)
        return np.full(self.n, m, dtype=m.dtype)

    def replace(self, **kw) -> "ParticleSet":
        d = {f: getattr(self, f) for f in self._array_fields}
        d.update(kw)
        return ParticleSet(**d)

    def take(self, idx) -> "ParticleSet":
        """Gather a (possibly permuted) subset along the particle axis."""
        d = {}
        for f in self._array_fields:
            v = getattr(self, f)
            if v is None or (f == "mass" and np.ndim(v) == 0):
                d[f] = v
            elif isinstance(v, torch.Tensor):
                d[f] = v[torch.as_tensor(idx, device=v.device)]
            else:
                d[f] = np.take(v, np.asarray(idx), axis=0)
        return ParticleSet(**d)

    @classmethod
    def from_numpy(cls, pos: np.ndarray, vel: np.ndarray, mass,
                   pid: Optional[np.ndarray] = None,
                   ptype: Optional[np.ndarray] = None,
                   dtype: torch.dtype = torch.float32,
                   device: Union[str, torch.device] = "cpu"
                   ) -> "ParticleSet":
        """Tensors on ``device`` of numpy inputs.  Ids above 2^31 - 1
        (reference VR_LONG_INT, CMakeLists.txt:43) become int64 tensors on
        the device like any other: torch has int64 there, where the
        reference keeps such ids on the host because its device arrays
        truncate to 32 bits."""
        def tensor(a, dt):
            return torch.as_tensor(np.asarray(a), device=device).to(dt)

        if pid is not None:
            pid_np = np.asarray(pid)
            big = pid_np.max(initial=0) > 2 ** 31 - 1
            pid = tensor(pid_np, torch.int64 if big else torch.int32)
        if ptype is not None:
            ptype = tensor(ptype, torch.int8)
        return cls(tensor(pos, dtype), tensor(vel, dtype),
                   tensor(mass, dtype), pid=pid, ptype=ptype)

    def __repr__(self):
        return f"ParticleSet(n={self.n}, dtype={self.pos.dtype})"
