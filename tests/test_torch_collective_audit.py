"""The port's mesh path moves boundaries and per-group tables between
shards, never a full-set array, and fetches nothing of n-scale to the host
but the catalog (the port's counterparts of tests/test_collective_audit.py
and tests/test_device_residency.py), and its CLI over ``VR_MESH=8`` CPU
shards writes the JAX CLI's catalogs.

* Collectives (``parallel/collectives.py`` counts every call by stage and
  kind): no call moves n x 4 bytes or more, and each stage's deals
  (``reshard``) stay under 24 x the full set, on the whole mesh run with
  the recursion and the baryon search.
* Host fetches: a ``TorchFunctionMode`` records every ``.numpy()``,
  ``.tolist()``, ``.item()``, array conversion and scalar conversion, and
  every ``.cpu()`` / ``.to("cpu")`` of a tensor on an accelerator, and
  fails on one of n-scale size outside ``utils/transfer.py``'s
  ``fetch_small`` and ``fetch_bulk``; the bulk fetches are the catalog's
  three payloads.  A case shows that the mode trips.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from velociraptor_stf_tpu import cli as jcli
from velociraptor_stf_tpu.utils import config as C

from velociraptor_stf_tpu_torch import cli as tcli
from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.io import gadget
from velociraptor_stf_tpu_torch.io.synthetic import make_cosmo_mock
from velociraptor_stf_tpu_torch.models import pipeline as TP
from velociraptor_stf_tpu_torch.parallel.mesh import make_mesh
from velociraptor_stf_tpu_torch.utils import telemetry, transfer

from test_torch_properties import CFG
from torch_threads import one_torch_thread  # noqa: F401

_MATERIALISE = {"numpy", "tolist", "item", "__array__", "__int__",
                "__float__", "__bool__", "__index__"}


class HostFetchAudit(TorchFunctionMode):
    """Raises on an unaudited host fetch of a tensor of ``big`` elements
    or more; records the audited ones."""

    def __init__(self, big: int):
        super().__init__()
        self.big = big
        self.audited = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        t = args[0] if args and isinstance(args[0], torch.Tensor) else None
        if t is not None:
            fetch = name in _MATERIALISE
            if name in ("cpu", "to") and t.device.type != "cpu":
                dst = kwargs.get("device", args[1] if len(args) > 1 else
                                 None)
                fetch = name == "cpu" or (
                    dst is not None and torch.device(dst).type == "cpu")
            if fetch and t.numel() >= self.big:
                if not transfer.in_audit():
                    raise RuntimeError(
                        f"unaudited host fetch ({name}) of a "
                        f"{t.numel()}-element tensor in the mesh path")
                self.audited.append(t.numel())
        return func(*args, **kwargs)


def _opt(n, boxsize, **over):
    opt = C.Options()
    opt.ellphys = 0.2
    opt.ellxscale = boxsize / n ** (1 / 3)
    opt.fofbgtype = C.FOF6D
    opt.MinSize = 20
    opt.HaloMinSize = 32
    opt.uinfo.unbindflag = 1
    opt.iBoundHalos = 1
    opt.uinfo.Eratio = 1.0
    opt.G = 43.0211349
    opt.iSubSearch = 0
    for k, v in over.items():
        setattr(opt, k, v)
    C.config_check(opt)
    return convert.options(opt)


def test_no_stage_moves_full_set_payloads():
    """tests/test_collective_audit.py:27-90 on the port: the whole mesh
    run with the recursion and the baryon search."""
    boxsize, n = 40.0, 1 << 16
    pos, vel, mass = make_cosmo_mock(n, boxsize=boxsize, nhalos=20, seed=9)
    ptype = np.where(np.arange(n) % 6 == 5, C.GASTYPE,
                     C.DARKTYPE).astype(np.int32)
    opt = _opt(n, boxsize, iSubSearch=1, iiterflag=1, iBaryonSearch=1,
               partsearchtype=C.PSTALL)
    telemetry.reset()
    res = TP.find_structures(opt, pos, vel, mass, boxsize=boxsize,
                             ptype=ptype, mesh=make_mesh(8, "cpu"),
                             device="cpu")
    assert res.ngroups > 0
    snap = telemetry.snapshot()
    byte_keys = [k for k in snap if k.startswith("coll_bytes::")]
    for stage in ("fof3d", "fof6d", "unbind", "props", "baryons",
                  "substructure"):
        assert any(f"::{stage}::" in k for k in byte_keys), (stage, snap)
    full_set_bytes = n * 4
    for k in byte_keys:
        ops = snap["coll_ops::" + k[len("coll_bytes::"):]]
        if k.endswith("::reshard"):
            assert snap[k] < 24 * full_set_bytes, (k, snap[k])
            continue
        assert snap[k] / max(ops, 1) < full_set_bytes, (k, snap[k], ops)


def _run_guarded(big):
    boxsize, n = 50.0, 1 << 15
    pos, vel, mass = make_cosmo_mock(n, boxsize=boxsize, nhalos=24, seed=11)
    opt = _opt(n, boxsize, iInclusiveHalo=3)
    tp, tv, tm = (torch.from_numpy(a) for a in (pos, vel, mass))
    telemetry.reset()
    audit = HostFetchAudit(big)
    with audit:
        res = TP.find_structures(opt, tp, tv, tm, boxsize=boxsize,
                                 mesh=make_mesh(8, "cpu"), device="cpu")
    return res, audit, telemetry.snapshot(), (opt, pos, vel, mass, boxsize)


def test_mesh_pipeline_no_interstage_fetches():
    """tests/test_device_residency.py on the port: no n-scale host fetch
    but the catalog's pfof, W and pfof3d, and the catalog is the one
    device's."""
    n = 1 << 15
    res, audit, snap, (opt, pos, vel, mass, boxsize) = _run_guarded(1 << 12)
    bulk = sorted(k for k in snap if k.startswith("mesh_full_gathers::"))
    assert bulk == ["mesh_full_gathers::catalog_W",
                    "mesh_full_gathers::catalog_pfof",
                    "mesh_full_gathers::pfof3d"], snap
    assert snap["mesh_full_gathers"] == 3
    assert sorted(audit.audited)[-3:] == [n, n, n]
    one = TP.find_structures(opt, pos, vel, mass, boxsize=boxsize,
                             device="cpu")
    assert res.ngroups == one.ngroups > 0
    np.testing.assert_array_equal(res.pfof, one.pfof)


def test_guard_actually_trips():
    """An unaudited n-scale fetch inside the mode raises; the audited
    fetches pass; a small fetch passes."""
    x = torch.arange(1 << 13)
    with HostFetchAudit(1 << 12):
        with pytest.raises(RuntimeError, match="unaudited host fetch"):
            x.numpy()
        with pytest.raises(RuntimeError, match="unaudited host fetch"):
            x.tolist()
        assert transfer.fetch_bulk(x, "t").shape == (1 << 13,)
        assert transfer.fetch_small(x[:10]).shape == (10,)
        assert int(x[5]) == 5


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both CLIs on one gadget snapshot with the sample config: the JAX
    package's on one device, the port's over ``VR_MESH=8`` CPU shards."""
    d = tmp_path_factory.mktemp("meshcli")
    boxsize, n = 20.0, 1 << 14
    pos, vel, mass = make_cosmo_mock(n, boxsize=boxsize, nhalos=16, seed=3)
    snap = str(d / "snap.gdt")
    gadget.write_gadget(snap, pos, vel, np.arange(1, n + 1),
                        np.ones(n, np.int8), mass, boxsize=boxsize,
                        time=1.0, omega0=0.3, omega_lambda=0.7, hubble=1.0)
    cfg = str(Path(__file__).resolve().parents[1] / CFG)
    old = os.environ.get("VR_MESH")
    try:
        os.environ["VR_MESH"] = "1"
        assert jcli.main(["-C", cfg, "-i", snap, "-I", "1", "-o",
                          str(d / "jax")]) == 0
        os.environ["VR_MESH"] = "8"
        assert tcli.main(["-C", cfg, "-i", snap, "-I", "1", "-o",
                          str(d / "torch"), "--device", "cpu"]) == 0
    finally:
        if old is None:
            os.environ.pop("VR_MESH", None)
        else:
            os.environ["VR_MESH"] = old
    return d


def test_cli_mesh_catalogs_match_reference(cli_runs, monkeypatch):
    """The port's CLI over VR_MESH=8 CPU shards writes the JAX CLI's
    (one device) group, particle and hierarchy catalogs byte for byte."""
    d = cli_runs
    for ext in (".catalog_groups", ".hierarchy", ".catalog_particles",
                ".catalog_particles.unbound"):
        assert (d / f"torch{ext}").read_bytes() == \
            (d / f"jax{ext}").read_bytes(), ext
    monkeypatch.setenv("VR_MESH", "8")
    mesh = tcli._auto_mesh("cpu")
    assert mesh is not None and mesh.size == 8
    monkeypatch.setenv("VR_MESH", "1")
    assert tcli._auto_mesh("cpu") is None
    monkeypatch.delenv("VR_MESH")
    assert tcli._auto_mesh("cpu") is None
