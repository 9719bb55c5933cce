"""Carry the reference package's intermediate results into the port.

The port has no learned state; what crosses between the two packages is
the shared ``Options`` object (the port reads the same config files
through the reference's jax-free ``utils/config.py``) and numpy particle
arrays.  These helpers turn the reference's intermediate numpy arrays into
the port's tensors on a device, so that one stage of the port can be fed
exactly what the reference's stage before it produced.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

Device = Union[str, torch.device]


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
