"""Bulk copies between host arrays and a card, and the audited host
fetches of the mesh path (port of velociraptor_stf_tpu/utils/transfer.py).

``stage_in`` puts an array (numpy, or a tensor on any device) on a device
as a contiguous tensor of a given dtype; ``fetch_bulk`` brings a
per-particle tensor back as numpy.  Where the copy crosses between host
memory and a CUDA card and the array holds at least ``STAGE_MIN_BYTES``,
it goes through the staging ring: ``RING_BUFFERS`` page-locked host
buffers of ``RING_BYTES`` each, allocated once per process on first use
and reused by every later copy, each with the CUDA event recorded after
its last DMA.  The array crosses in chunks of one buffer, on the
device's current stream: in, the host copies chunk i+1 into the next
buffer while the DMA of chunk i runs; out, the host copies chunk i out of
its buffer while the DMA of chunk i+1 runs.  A buffer is written again
only once its event has passed.  An array crosses at its own width where
that is narrower than the target's, and is widened on the card
(particle types as int8, int64 on the card); else at the target's,
converted by the host's copy into the buffer.  Every other copy (on the
CPU, between devices, of a smaller array, of a dtype the ring does not
take) is the direct ``.to(...)`` / ``.cpu()``.

The mesh path keeps particle arrays on the devices from the input to the
catalog: the host sees scalars and per-group tables, fetched through
``fetch_small``, and the catalog's per-particle payloads, fetched once
through ``fetch_bulk``.  Both mark their fetches as audited
(``in_audit``), so a test can record every other fetch and fail on one of
n-scale size (tests/test_torch_collective_audit.py).

Counted in ``utils/telemetry``: ``transfer_staged_bytes`` and
``transfer_staged_chunks`` (bytes and chunks through the ring, either
way), ``transfer_direct_bytes`` (bytes of the arrays that took the
direct copy from another device or from numpy), ``transfer_pinned_bytes``
(the ring's page-locked bytes, once, when it is allocated), and
``fetch_bulk``'s ``mesh_full_gathers`` and ``mesh_full_gathers::<what>``.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import telemetry

# the ring's shape: of 2 and 4 buffers of 8-64 MiB on an H100 80GB HBM3,
# two of 32 MiB moved the hydro cell's 598 MB in fastest (28 GB/s against
# 3.6 for the direct copy) and its catalog's 133 MB out at 3.9 GB/s
# against 1.9 (PERF.md §6); and the smallest array worth a chunked copy
RING_BUFFERS = 2
RING_BYTES = 32 << 20
STAGE_MIN_BYTES = 1 << 20

# numpy dtypes the ring takes: native byte order, a torch counterpart
# that ``copy_`` converts
_RING_NP = frozenset(np.dtype(t) for t in (
    np.bool_, np.int8, np.uint8, np.int16, np.int32, np.int64, np.float16,
    np.float32, np.float64))

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


def chunk_plan(n: int, step: int) -> List[Tuple[int, int]]:
    """[start, stop) element ranges of at most ``step`` covering 0..n."""
    return [(a, min(a + step, n)) for a in range(0, n, step)]


class _Ring:
    """The page-locked staging buffers, each with the event after its
    last DMA; ``lock`` is held for a whole array's copy."""

    def __init__(self, nbuf: int, nbytes: int):
        self.bufs = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                     for _ in range(nbuf)]
        self.done: List[Optional[torch.cuda.Event]] = [None] * nbuf
        self.nbytes = nbytes
        self.next = 0
        self.lock = threading.Lock()
        telemetry.count("transfer_pinned_bytes", nbuf * nbytes)

    def take(self, dtype: torch.dtype, count: int):
        """The next buffer, as ``count`` elements of ``dtype``, once its
        last DMA has passed."""
        i = self.next
        self.next = (i + 1) % len(self.bufs)
        self.wait(i)
        return i, self.bufs[i][:count * dtype.itemsize].view(dtype)

    def wait(self, i: int) -> None:
        if self.done[i] is not None:
            self.done[i].synchronize()
            self.done[i] = None

    def mark(self, i: int, stream) -> None:
        ev = torch.cuda.Event()
        ev.record(stream)
        self.done[i] = ev


_RING: Optional[_Ring] = None
_RING_ALLOC = threading.Lock()


def _ring() -> _Ring:
    global _RING
    with _RING_ALLOC:
        if _RING is None:
            _RING = _Ring(RING_BUFFERS, RING_BYTES)
        return _RING


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _ring_source(x) -> Optional[torch.Tensor]:
    """``x`` as a contiguous CPU tensor over its own values where the ring
    takes it, else None."""
    if isinstance(x, torch.Tensor):
        return x.contiguous() if x.device.type == "cpu" else None
    if x.dtype not in _RING_NP:
        return None
    return torch.from_numpy(np.ascontiguousarray(x))


def stage_in(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``x`` (numpy or a tensor) as a contiguous ``dtype`` tensor on
    ``device``: through the ring from host memory to a CUDA card, else by
    the direct copy (a tensor already there as it is)."""
    device = torch.device(device)
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    if device.type == "cuda" and x.nbytes >= STAGE_MIN_BYTES:
        src = _ring_source(x)
        if src is not None:
            return _ring_in(src, device, dtype)
    if not isinstance(x, torch.Tensor):
        telemetry.count("transfer_direct_bytes", x.nbytes)
        x = torch.from_numpy(np.ascontiguousarray(x, _np_dtype(dtype)))
    elif x.device.type != device.type:
        telemetry.count("transfer_direct_bytes", x.nbytes)
    return x.to(device=device, dtype=dtype).contiguous()


def _ring_in(src: torch.Tensor, device: torch.device,
             dtype: torch.dtype) -> torch.Tensor:
    wire = src.dtype if src.element_size() < dtype.itemsize else dtype
    out = torch.empty(src.shape, dtype=wire, device=device)
    flat, dst = src.view(-1), out.view(-1)
    ring = _ring()
    stream = torch.cuda.current_stream(out.device)
    plan = chunk_plan(flat.numel(), ring.nbytes // out.element_size())
    with ring.lock:
        for a, b in plan:
            i, buf = ring.take(wire, b - a)
            buf.copy_(flat[a:b])
            dst[a:b].copy_(buf, non_blocking=True)
            ring.mark(i, stream)
    telemetry.count("transfer_staged_bytes", out.nbytes)
    telemetry.count("transfer_staged_chunks", len(plan))
    return out if wire == dtype else out.to(dtype)


def _ring_out(t: torch.Tensor) -> np.ndarray:
    src = t.contiguous().view(-1)
    out = torch.empty(t.shape, dtype=t.dtype)
    dst = out.view(-1)
    ring = _ring()
    stream = torch.cuda.current_stream(t.device)
    plan = chunk_plan(src.numel(), ring.nbytes // t.element_size())
    inflight: collections.deque = collections.deque()

    def drain():
        i, buf, a, b = inflight.popleft()
        ring.wait(i)
        dst[a:b].copy_(buf)

    with ring.lock:
        for a, b in plan:
            if len(inflight) == len(ring.bufs):
                drain()
            i, buf = ring.take(t.dtype, b - a)
            buf.copy_(src[a:b], non_blocking=True)
            ring.mark(i, stream)
            inflight.append((i, buf, a, b))
        while inflight:
            drain()
    telemetry.count("transfer_staged_bytes", t.nbytes)
    telemetry.count("transfer_staged_chunks", len(plan))
    return out.numpy()


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
    the catalog's payloads.  A tensor on a CUDA card of at least
    ``STAGE_MIN_BYTES`` comes through the ring."""
    telemetry.count("mesh_full_gathers")
    if what:
        telemetry.count(f"mesh_full_gathers::{what}")
    with _audited():
        if not isinstance(x, torch.Tensor):
            return _get(x)
        if x.device.type == "cuda" and x.nbytes >= STAGE_MIN_BYTES:
            return _ring_out(x)
        if x.device.type != "cpu":
            telemetry.count("transfer_direct_bytes", x.nbytes)
        return x.cpu().numpy()
