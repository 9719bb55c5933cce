"""Audited device-to-host fetches of the mesh path (port of
velociraptor_stf_tpu/utils/transfer.py).

The mesh path keeps particle arrays on the devices from the input to the
catalog: the host sees scalars and per-group tables, fetched through
``fetch_small``, and the catalog's per-particle payloads, fetched once
through ``fetch_bulk``.  Both mark their fetches as audited
(``in_audit``), so a test can record every other fetch and fail on one of
n-scale size (tests/test_torch_collective_audit.py).  ``fetch_bulk``
counts its fetches in ``utils/telemetry``: ``mesh_full_gathers`` and
``mesh_full_gathers::<what>``.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from . import telemetry

_audit = threading.local()


def in_audit() -> bool:
    """True inside ``fetch_small`` / ``fetch_bulk``."""
    return getattr(_audit, "on", False)


@contextlib.contextmanager
def _audited():
    prev = in_audit()
    _audit.on = True
    try:
        yield
    finally:
        _audit.on = prev


def _get(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_get(v) for v in x)
    if isinstance(x, dict):
        return {k: _get(v) for k, v in x.items()}
    return np.asarray(x)


def fetch_small(x):
    """Scalars and per-group tables (tensors, or lists, tuples or dicts of
    them) as numpy: the analog of the reference's MPI_Allreduce'd group
    counts, never per-particle data."""
    with _audited():
        return _get(x)


def fetch_bulk(x, what: str = ""):
    """A per-particle array as numpy, counted: the mesh path's budget is
    the catalog's payloads."""
    telemetry.count("mesh_full_gathers")
    if what:
        telemetry.count(f"mesh_full_gathers::{what}")
    with _audited():
        return _get(x)
