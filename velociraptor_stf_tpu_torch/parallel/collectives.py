"""Collectives between the shards of a mesh (port of
velociraptor_stf_tpu/parallel/collectives.py), the only code that moves
data from one shard to another.

A sharded value is a list with one tensor per shard, shard ``s`` on
``mesh.devices[s]``.  Data moves by ``Tensor.to(dst, non_blocking=True)``;
reductions add (or take the min / max of) the shards' tensors in the fixed
order 0..n-1 on the home device and hand every shard a copy, so a result
does not depend on which device holds which shard.

Every call records its payload under the current stage label
(``audit_stage`` / ``staged``): ``coll_bytes::<stage>::<kind>`` and
``coll_ops::<stage>::<kind>`` in ``utils/telemetry``.  The JAX package
counts when its program is traced, once per compile; the port counts every
call, so the counters are totals of the run.  The bytes of a call are its
largest per-shard payload: for ``ppermute`` the slab that one link
carries, for the reductions the reduced shape (as the JAX package counts
them).  ``count_reshard`` records a deal of whole-array data onto the
shards (kind ``reshard``), whose bytes are each element once.  With no
stage label the calls count nothing.
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from ..utils import telemetry
from .mesh import Mesh

_STAGE: Optional[str] = None


@contextlib.contextmanager
def audit_stage(name: str):
    """Label the collectives called within the context (inner labels
    win)."""
    global _STAGE
    prev = _STAGE
    _STAGE = name
    try:
        yield
    finally:
        _STAGE = prev


def current_stage() -> Optional[str]:
    """The innermost stage label, None outside every stage."""
    return _STAGE


def staged(name: str):
    """Decorator: run a stage's entry point under ``audit_stage(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with audit_stage(name):
                return fn(*a, **k)
        return wrapper
    return deco


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return sum(_nbytes(v) for v in x)


def _count(kind: str, nbytes: int, stage: Optional[str] = None) -> None:
    stage = stage or _STAGE
    if stage is None:
        return
    telemetry.count(f"coll_bytes::{stage}::{kind}", nbytes)
    telemetry.count(f"coll_ops::{stage}::{kind}")


def move(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return x.to(device, non_blocking=True)


def ppermute(mesh: Mesh, xs: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``out[dst] = xs[src]`` for each (src, dst) of ``perm``, on the
    destination's device; a shard that receives nothing gets zeros."""
    _count("ppermute", max((_nbytes(xs[s]) for s, _ in perm), default=0))
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for src, dst in perm:
        out[dst] = move(xs[src], mesh.devices[dst])
    return [o if o is not None else
            torch.zeros_like(xs[d], device=mesh.devices[d])
            for d, o in enumerate(out)]


def ring(mesh: Mesh, step: int) -> List[Tuple[int, int]]:
    """The ring permutation sending shard i to shard i + step."""
    n = mesh.size
    return [(i, (i + step) % n) for i in range(n)]


def _reduce(kind: str, mesh: Mesh, xs: Sequence[torch.Tensor],
            op) -> List[torch.Tensor]:
    _count(kind, _nbytes(xs[0]))
    acc = move(xs[0], mesh.home)
    for x in xs[1:]:
        acc = op(acc, move(x, mesh.home))
    return [move(acc, d) for d in mesh.devices]


def psum(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum over the shards, added in shard order; every shard gets it."""
    return _reduce("psum", mesh, xs, torch.add)


def pmax(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return _reduce("pmax", mesh, xs, torch.maximum)


def pmin(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return _reduce("pmin", mesh, xs, torch.minimum)


def all_gather(mesh: Mesh, xs: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
    """Every shard gets the (n, ...) stack of all shards' tensors."""
    _count("all_gather", _nbytes(xs[0]))
    stack = torch.stack([move(x, mesh.home) for x in xs])
    return [move(stack, d) for d in mesh.devices]


def count_reshard(stage: str, x) -> None:
    """Record a deal of whole-array data onto the shards (or the gather
    of shard blocks back into one array): each element moves once."""
    _count("reshard", _nbytes(x), stage)
