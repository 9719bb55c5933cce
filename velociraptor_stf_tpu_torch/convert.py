"""Carry the JAX package's state into the port.

The halo finder has no learned weights.  What one run carries into the
next stage is its ``Options`` and its intermediate arrays.  The port keeps
its own copy of the options module (``utils/config.py``) and never imports
the JAX package, so the state crosses as plain values:

* ``options`` turns the JAX package's ``Options`` into the port's, field
  for field, nested dataclasses (``UnbindInfo``, ``PropInfo``) included
  (``unbind_info`` does the same for a bare ``UnbindInfo``);
* ``group_ids``, ``per_particle_scale`` and ``potential`` turn the JAX
  package's intermediate numpy arrays into the port's tensors on a device,
  so that one stage of the port can be fed exactly what the JAX package's
  stage before it produced.

Nothing here imports the JAX package: its objects arrive as arguments.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Union

import numpy as np
import torch

from .utils import config as C

Device = Union[str, torch.device]


def _copy_dataclass(src, cls):
    """A ``cls`` whose fields are ``src``'s fields of the same names; a
    field that is itself a dataclass becomes the class ``cls`` declares for
    it.  A field that either side lacks is an error."""
    mine = {f.name for f in dataclasses.fields(cls)}
    theirs = {f.name for f in dataclasses.fields(src)}
    if mine != theirs:
        raise TypeError(f"{type(src).__name__} -> {cls.__name__}: fields "
                        f"differ: {sorted(mine ^ theirs)}")
    out = cls()
    for f in dataclasses.fields(cls):
        value = getattr(src, f.name)
        default = getattr(out, f.name)
        if dataclasses.is_dataclass(default):
            value = _copy_dataclass(value, type(default))
        else:
            value = copy.deepcopy(value)
        setattr(out, f.name, value)
    # attributes set after construction (the CLI's nsnapread, ...)
    for key, value in vars(src).items():
        if key not in mine:
            setattr(out, key, copy.deepcopy(value))
    return out


def options(jax_opt) -> C.Options:
    """The port's ``Options`` equal, field for field, to the JAX package's
    ``jax_opt`` (a deep copy: later changes to one do not reach the
    other)."""
    return _copy_dataclass(jax_opt, C.Options)


def unbind_info(jax_uinfo) -> C.UnbindInfo:
    """The port's ``UnbindInfo`` equal to the JAX package's, field for
    field (for callers of ``models.unbind`` that hold no ``Options``)."""
    return _copy_dataclass(jax_uinfo, C.UnbindInfo)


def group_ids(pfof, device: Device = "cpu") -> torch.Tensor:
    """(N,) group ids (e.g. the reference's 3DFOF ``pfof3d``) as int64."""
    return torch.from_numpy(np.asarray(pfof).astype(np.int64)).to(device)


def per_particle_scale(vscale2, device: Device = "cpu") -> torch.Tensor:
    """(N,) per-particle 6D velocity scale (``FieldSearchResult.vscale2``)
    as float32, bit for bit."""
    return torch.from_numpy(np.asarray(vscale2).astype(np.float32)).to(
        device)


def potential(W, device: Device = "cpu") -> torch.Tensor:
    """(N,) potential energies (``UnbindResult.W``), keeping their float
    dtype."""
    W = np.asarray(W)
    if W.dtype not in (np.float32, np.float64):
        raise TypeError(f"W: expected float32 or float64, got {W.dtype}")
    return torch.from_numpy(np.array(W)).to(device)
