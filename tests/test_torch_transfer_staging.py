"""The bulk copies of ``utils/transfer.py``: the staging ring's chunk plan
covers every element once; the ring's copies in and out give the direct
copy's values, with each array crossing at the narrower of its own and
the target's width; on the CPU every copy is direct and the catalog the
same; particle types widen alike from any integer width.

The ``gpu`` tests hold the ring on a card to the direct copy bit for bit,
its reuse over many more chunks than buffers, ``fetch_bulk`` to
``.cpu().numpy()``, and a hydro catalog from host arrays to the one from
tensors copied directly.  This file imports no jax: on a card it runs with

    python -m pytest tests/test_torch_transfer_staging.py --noconftest -q
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from velociraptor_stf_tpu_torch.io.synthetic import (G_KMS, example_snapshot,
                                                     planted_subhalos)
from velociraptor_stf_tpu_torch.models import pipeline
from velociraptor_stf_tpu_torch.utils import config as C
from velociraptor_stf_tpu_torch.utils import telemetry, transfer, units

from torch_threads import one_torch_thread  # noqa: F401

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _counts(fn):
    """``fn()`` and the telemetry counts it added."""
    before = telemetry.snapshot()
    out = fn()
    after = telemetry.snapshot()
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _same_catalog(a, b) -> bool:
    return all((x is None and y is None) or _same_bits(x, y) for x, y in (
        (a.pfof, b.pfof), (a.W, b.W), (a.pfof3d, b.pfof3d),
        (a.hostid, b.hostid), (a.parent, b.parent),
        (a.hierarchy_level, b.hierarchy_level))) and \
        a.ngroups == b.ngroups and set(a.props) == set(b.props) and \
        all(_same_bits(a.props[k], b.props[k]) for k in a.props)


# ---- CPU ------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [1, 4, 8])
@pytest.mark.parametrize("size", ["0", "1", "chunk-1", "chunk", "chunk+1",
                                  "5 chunks+3"])
def test_chunk_plan_covers_every_element_once(itemsize, size):
    step = transfer.RING_BYTES // itemsize
    n = {"0": 0, "1": 1, "chunk-1": step - 1, "chunk": step,
         "chunk+1": step + 1, "5 chunks+3": 5 * step + 3}[size]
    plan = transfer.chunk_plan(n, step)
    assert len(plan) == -(-n // step)
    stops = [0] + [b for _, b in plan]
    assert [a for a, _ in plan] == stops[:-1] and stops[-1] == n
    assert all(0 < b - a <= step for a, b in plan)


class _Event:
    """A CUDA event's part in the ring, for the CPU: a wait on it must
    follow its record."""

    def __init__(self):
        self.recorded = False

    def record(self, stream=None):
        self.recorded = True

    def synchronize(self):
        assert self.recorded


@pytest.fixture
def cpu_ring(monkeypatch):
    """The ring's code on the CPU: three plain buffers of 64 bytes, events
    that only check they were recorded before a wait."""
    ring = transfer._Ring.__new__(transfer._Ring)
    ring.bufs = [torch.empty(64, dtype=torch.uint8) for _ in range(3)]
    ring.done, ring.nbytes, ring.next = [None] * 3, 64, 0
    ring.lock = transfer.threading.Lock()
    monkeypatch.setattr(transfer, "_RING", ring)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        None)
    return ring


_RING_CASES = {
    # name: (source, target dtype, bytes that cross)
    "float32": (np.arange(70, dtype=np.float32) * 0.37, torch.float32, 280),
    "float64->float32": (np.linspace(-3, 3, 33), torch.float32, 132),
    "int8->int64": ((np.arange(200) % 5 - 2).astype(np.int8), torch.int64,
                    200),
    "int32->int64": ((np.arange(41) * 7919 - 10 ** 5).astype(np.int32),
                     torch.int64, 164),
    "non-contiguous (n, 3)": (np.arange(150, dtype=np.float32).reshape(
        50, 3)[::2], torch.float32, 300),
    "one chunk": (np.arange(16, dtype=np.float32), torch.float32, 64),
    "one chunk+1": (np.arange(17, dtype=np.float32), torch.float32, 68),
}


@pytest.mark.parametrize("case", sorted(_RING_CASES))
def test_ring_in_and_out_give_the_direct_copy_on_cpu(cpu_ring, case):
    x, dtype, wire = _RING_CASES[case]
    want = torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
    got, counts = _counts(lambda: transfer._ring_in(
        transfer._ring_source(x), torch.device("cpu"), dtype))
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, want)
    chunks = -(-wire // 64)
    assert counts == {"transfer_staged_bytes": wire,
                      "transfer_staged_chunks": chunks}
    back, counts = _counts(lambda: transfer._ring_out(got))
    assert _same_bits(back, want.numpy())
    assert counts["transfer_staged_bytes"] == got.nbytes
    assert all(e is None or e.recorded for e in cpu_ring.done)


def _hydro_input():
    """Planted hosts with every third particle gas and hydro fields."""
    pos, vel, mass, _ = planted_subhalos(2, seed=3, offset=4.0)
    n = len(pos)
    rng = np.random.default_rng(5)
    ptype = np.where(np.arange(n) % 3 == 2, 0, 1).astype(np.int8)
    extras = {k: rng.uniform(0.0, 1.0, n).astype(np.float32)
              for k in ("u", "sfr", "zmet", "tage")}
    return pos, vel, mass, ptype, extras


def _hydro_options():
    opt = C.Options()
    opt.ellphys, opt.ellxscale = 0.2, 0.25
    opt.fofbgtype = C.FOF3D
    opt.MinSize = opt.HaloMinSize = 20
    opt.uinfo.unbindflag, opt.iBoundHalos, opt.G = 1, 1, G_KMS
    opt.iBaryonSearch = 1
    C.config_check(opt)
    return opt


def test_find_structures_on_cpu_copies_directly():
    pos, vel, mass, ptype, extras = _hydro_input()
    opt = _hydro_options()
    got, counts = _counts(lambda: pipeline.find_structures(
        copy.deepcopy(opt), pos, vel, mass, boxsize=12.0, ptype=ptype,
        extras=extras, device="cpu"))
    assert "transfer_staged_bytes" not in counts
    assert "transfer_staged_chunks" not in counts
    assert counts["transfer_direct_bytes"] == sum(
        a.nbytes for a in (pos, vel, mass, ptype, *extras.values()))
    tensors = {k: torch.from_numpy(v) for k, v in extras.items()}
    want = pipeline.find_structures(
        copy.deepcopy(opt), *(torch.from_numpy(a) for a in (pos, vel, mass)),
        boxsize=12.0, ptype=torch.from_numpy(ptype), extras=tensors,
        device="cpu")
    assert got.ngroups > 1 and _same_catalog(got, want)


@pytest.mark.parametrize("width", [np.int8, np.int32, np.int64])
def test_as_ptype_widens_any_integer_width_alike(width):
    types = np.array([0, 1, 4, 5, 1, 0, 2, 3] * 9)
    got = pipeline._as_ptype(types.astype(width), torch.device("cpu"))
    assert got.dtype == torch.int64
    assert torch.equal(got, torch.from_numpy(types.astype(np.int64)))
    assert pipeline._as_ptype(None, torch.device("cpu")) is None


# ---- card -----------------------------------------------------------------

def _sizes():
    step = transfer.RING_BYTES // 4
    return {"chunk-1": step - 1, "chunk": step, "chunk+1": step + 1,
            "3 chunks+5": 3 * step + 5}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["float32", "float64->float32",
                                  "int8->int64", "non-contiguous",
                                  "chunk-1", "chunk", "chunk+1",
                                  "3 chunks+5"])
def test_cuda_staged_copy_in_equals_direct(cuda, case):
    rng = np.random.default_rng(11)
    n = _sizes().get(case, 1 << 22)
    dtype = torch.float32
    if case == "float64->float32":
        x = rng.standard_normal(n)
    elif case == "int8->int64":
        x, dtype = rng.integers(-128, 128, n).astype(np.int8), torch.int64
    elif case == "non-contiguous":
        x = rng.standard_normal((n, 6)).astype(np.float32)[:, 1:4]
    else:
        x = rng.standard_normal(n).astype(np.float32)
    want = torch.from_numpy(np.ascontiguousarray(
        x, transfer._np_dtype(dtype))).to(cuda)
    got, counts = _counts(lambda: transfer.stage_in(x, cuda, dtype))
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got.view(-1).view(torch.uint8),
                       want.view(-1).view(torch.uint8))
    wire = x.size * min(x.itemsize, want.element_size())
    assert counts["transfer_staged_bytes"] == wire
    assert "transfer_direct_bytes" not in counts


@pytest.mark.gpu
def test_cuda_ring_reuse_never_overwrites_a_buffer_in_flight(cuda):
    """Arrays of many more chunks than buffers, issued back to back with
    no wait between them: every element arrives as sent."""
    step = transfer.RING_BYTES // 4
    n = 4 * len(transfer._ring().bufs) * step + 17
    xs = [np.arange(n, dtype=np.int32) * 3 + k for k in range(3)]
    got = [transfer.stage_in(x, cuda, torch.int32) for x in xs]
    # the card's own work between the copies and their check
    back = [transfer.fetch_bulk(g * 1) for g in got]
    for x, g, b in zip(xs, got, back):
        assert torch.equal(g.cpu(), torch.from_numpy(x))
        assert _same_bits(b, x)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["int32", "float32", "chunk-1", "chunk",
                                  "chunk+1", "3 chunks+5", "non-contiguous"])
def test_cuda_staged_fetch_bulk_equals_cpu(cuda, case):
    gen = torch.Generator(device=cuda).manual_seed(12)
    n = _sizes().get(case, (1 << 22) + 3)
    if case == "int32":
        t = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                          device=cuda, dtype=torch.int32)
    elif case == "non-contiguous":
        t = torch.randn(n, 3, generator=gen, device=cuda)[:, 1]
    else:
        t = torch.randn(n, generator=gen, device=cuda)
    got, counts = _counts(lambda: transfer.fetch_bulk(t))
    assert _same_bits(got, t.cpu().numpy())
    assert counts["transfer_staged_bytes"] == t.nbytes


@pytest.mark.gpu
def test_cuda_hydro_catalog_from_host_arrays_equals_direct_copies(cuda):
    """The swift hydro example's config on 2.3M particles (a sixth of them
    gas, every array above the ring's threshold): host arrays through the
    ring give the catalog of tensors copied to the card directly."""
    pos, vel, mass, ptype = example_snapshot("hydro", nhosts=8,
                                             nbg=1 << 21, boxsize=60.0,
                                             spacing=20.0)
    rng = np.random.default_rng(3)
    extras = {k: rng.uniform(0.0, 1.0, len(pos)).astype(np.float32)
              for k in ("u", "sfr", "zmet", "tage")}
    opt = C.parse_config_file(
        str(EXAMPLES / "sample_swifthydro_6dfof_subhalo.cfg"))
    C.config_check(opt)
    opt.a, opt.p = 1.0, 60.0
    opt.ellxscale = units.interparticle_spacing(60.0, len(pos))
    assert ptype.nbytes >= transfer.STAGE_MIN_BYTES
    got, counts = _counts(lambda: pipeline.find_structures(
        copy.deepcopy(opt), pos, vel, mass, boxsize=60.0, ptype=ptype,
        extras=extras, device=cuda))
    assert counts["transfer_staged_bytes"] >= sum(
        a.nbytes for a in (pos, vel, mass, ptype, *extras.values()))
    want = pipeline.find_structures(
        copy.deepcopy(opt), *(torch.from_numpy(a).to(cuda)
                              for a in (pos, vel, mass)),
        boxsize=60.0, ptype=torch.from_numpy(ptype.astype(np.int64)).to(cuda),
        extras={k: torch.from_numpy(v).to(cuda) for k, v in extras.items()},
        device=cuda)
    assert got.ngroups > 8 and _same_catalog(got, want)
