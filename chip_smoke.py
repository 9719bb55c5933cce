#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--n N] [--cli-n N] [--profile PATH]

Builds the port's CUDA kernels from ``velociraptor_stf_tpu_torch/kernels/
csrc`` and drives the port on the card, in phases:

1. a CUDA device must be present (the script never falls back to the CPU);
2. each kernel against its plain PyTorch version, on the card, at the
   shapes the main path gives it: detect counts and sweep labels exactly
   equal, the potential within rel 1e-4; times of both;
3. ``search_and_unbind`` on the small oracle case of tests/test_oracles.py
   against the independent float64 oracle chain: the partition must be
   exact;
4. the main path, ``models.pipeline.find_structures`` (3DFOF -> 6DFOF ->
   field unbind -> properties -> all-particle SO), at N = 256^3 (the
   bench's mock, seed 7) with the slice's options (the bench's search
   options, the property block of examples/sample_dmcosmological_run.cfg),
   twice, the first time as warm-up; every kernel's launch count over the
   second run must be > 0, the catalog must be well formed and both runs
   must give the same group ids, potentials and property arrays, bit for
   bit;
5. properties on the card: every group's size, mass and centre against a
   float64 numpy recomputation from the returned group ids (counts exact,
   rel 1e-5); the Plummer halo of tests/test_oracles.py against the
   float64 SO oracle (5e-3); the analytic SO case of tests/test_so.py
   (R within 3%, M within 4%);
6. the CLI, ``python -m velociraptor_stf_tpu_torch.cli``, on a 128^3
   gadget snapshot with binary output (the card's machine has no h5py):
   the catalog files must parse and hold find_structures' group count on
   the same snapshot;
7. the bucket tree: one 1,200,000-member group (above ``MAX_DIRECT``)
   through ``compute_potential`` (the tree) and through the direct kernel;
   the JAX package's tree tolerance against the exact sum (median rel
   error < 0.005, 99th percentile < 0.03); times of both.

Any failure exits non-zero.  The last line of stdout is the JSON result
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

BOXSIZE = 100.0
POT_RTOL = 1e-4
REPO = Path(__file__).resolve().parent
SLICE_CFG = REPO / "examples" / "sample_dmcosmological_run.cfg"
# the bench's search options over the sample config's property block, and
# binary catalogs
SLICE_OVERRIDES = """
Physical_linking_length=0.2
Halo_3D_linking_length=0.2
FoF_Field_search_type=4
Minimum_size=20
Minimum_halo_size=32
Search_for_substructure=0
Bound_halos=1
Allowed_kinetic_potential_ratio=1.0
Iterate_cm_flag=0
Binary_output=1
"""
TREE_N = 1_200_000


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bench_options(n: int, C, boxsize: float):
    """The options of bench.py (FOF6D, Bound_halos=1, no substructure)."""
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
    opt.Omega_m, opt.Omega_Lambda = 0.3, 0.7
    opt.iSubSearch = 0
    opt.iIterateCM = 0
    C.config_check(opt)
    return opt


def slice_options(n: int, C, boxsize: float, cfg_path: Path):
    """The slice's options: the config file ``cfg_path`` (the sample
    config with SLICE_OVERRIDES) with the interparticle spacing of n
    particles in the box, as the CLI derives it from a snapshot."""
    opt = C.parse_config_file(str(cfg_path))
    opt.ellxscale = boxsize / n ** (1 / 3)
    opt.Omega_m, opt.Omega_Lambda = 0.3, 0.7
    C.config_check(opt)
    return opt


def write_slice_config(path: Path, outname: str = "") -> Path:
    text = SLICE_CFG.read_text() + SLICE_OVERRIDES
    if outname:
        text += f"Output={outname}\n"
    path.write_text(text)
    return path


def oracle_chain(pos, vel, mass, opt, boxsize, oracles):
    """FOF3D -> vscale -> 6DFOF -> per-group unbind -> renumber, entirely
    in float64 numpy/scipy (copy of tests/test_oracles.py's chain)."""
    import numpy as np

    minsize = opt.HaloMinSize if opt.HaloMinSize > 0 else opt.MinSize
    b3d = opt.ellphys * opt.ellxscale * opt.ellhalophysfac
    pfof3, ng3 = oracles.fof3d_partition_oracle(pos, b3d, boxsize, minsize)
    if ng3 == 0:
        return pfof3, 0
    vs = oracles.vscale_oracle(vel, mass, pfof3, ng3, opt.ellhalo6dvfac,
                               adaptive=False)
    pfof6, ng6 = oracles.fof6d_partition_oracle(
        pos, vel, pfof3, b3d * opt.ellhalo6dxfac, float(vs[1]), boxsize,
        minsize)
    bound = np.zeros(len(pfof6), bool)
    for g in range(1, ng6 + 1):
        idx = np.nonzero(pfof6 == g)[0]
        pg = oracles.unwrap_group_oracle(pos[idx], boxsize)
        alive = oracles.unbind_oracle(
            pg, vel[idx], mass[idx], eps=opt.uinfo.eps, G=opt.G,
            Eratio=opt.uinfo.Eratio,
            maxunbindfrac=opt.uinfo.maxunbindfrac, min_size=minsize,
            bgpot=opt.uinfo.bgpot)
        bound[idx[alive]] = True
    raw = np.where(bound, pfof6, -1 - np.arange(len(pfof6)))
    relab, ng = oracles.renumber_by_size_oracle(raw, minsize,
                                                tiebreak="label")
    return np.where(raw > 0, relab, 0), ng


def cuda_ms(torch, fn, reps: int = 3) -> float:
    """Mean device time of ``fn()`` in ms (CUDA events, after a warm-up)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(torch, fn) -> float:
    """Wall time of one ``fn()`` in ms, synchronised (plain versions loop
    on the host, so CUDA events would time the same span)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def check_kernels(torch, np, pos, vel, mass, opt, report):
    """Phase 2: every kernel against its plain version at the main path's
    shapes on the 256^3 context."""
    from velociraptor_stf_tpu_torch.kernels import R_BLOCK
    from velociraptor_stf_tpu_torch.kernels import fof_sweep as KF
    from velociraptor_stf_tpu_torch.kernels import potential as KP
    from velociraptor_stf_tpu_torch.models import halos
    from velociraptor_stf_tpu_torch.ops import gravity_direct
    from velociraptor_stf_tpu_torch.ops import segments as seg
    from velociraptor_stf_tpu_torch.ops.fof_sweep import SweepFof

    b3d = opt.ellphys * opt.ellxscale * opt.ellhalophysfac
    reach = b3d * max(1.0, opt.ellhalo6dxfac)
    b2 = b3d * b3d
    fof = SweepFof(pos, vel, BOXSIZE, reach)
    ctx = fof.ctx
    # a row block with no windows must give count 0 / its own labels
    win = ctx.windows.clone()
    zero_blocks = torch.tensor([0, win.shape[0] // 2, win.shape[0] - 1],
                               device=win.device)
    win[zero_blocks] = 0

    def candidate_pairs(windows, rows):
        """(row, column) pairs a launch scans: rows x window lengths."""
        per_block = torch.full((windows.shape[0],), R_BLOCK,
                               dtype=torch.int64, device=windows.device)
        per_block[-1] = rows - (windows.shape[0] - 1) * R_BLOCK
        return int((per_block * windows[:, :, 1].long().sum(1)).sum())

    def entry(name, source, replaces, err, ms, plain_ms, rows,
              plain_rows, ms_plain_rows, windows):
        pairs = candidate_pairs(windows, rows)
        report.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": 0,
                       "max_abs_err": float(err), "ms": ms,
                       "plain_ms": plain_ms, "rows": rows,
                       "plain_rows": plain_rows,
                       "ms_plain_rows": ms_plain_rows,
                       "candidate_pairs": pairs,
                       "pairs_per_s": pairs / (ms * 1e-3)})
        log(f"kernel {name}: max_abs_err {err} kernel {ms:.3f} ms "
            f"({rows} rows, {pairs} candidate pairs, "
            f"{pairs / (ms * 1e-3):.4g}/s), plain {plain_ms:.3f} ms "
            f"({plain_rows} rows)")

    fof_src = "velociraptor_stf_tpu_torch/kernels/csrc/fof_sweep.cu"
    # detect: the full context, as linked_mask runs it
    got = KF.detect(ctx.pos, win, b2)
    want = KF.detect_ref(ctx.pos, win, KF.f32(b2))
    if not torch.equal(got, want):
        raise AssertionError("detect kernel disagrees with detect_ref: "
                             f"{int((got != want).sum())} rows")
    if int(got[:R_BLOCK].sum()) != 0:
        raise AssertionError("detect: a block with no windows counted")
    ms = cuda_ms(torch, lambda: KF.detect(ctx.pos, ctx.windows, b2))
    pms = wall_ms(torch, lambda: KF.detect_ref(ctx.pos, ctx.windows,
                                               KF.f32(b2)))
    entry("fof_detect", fof_src, "velociraptor_stf_tpu/ops/pallas_fof.py:613",
          0, ms, pms, ctx.ns, ctx.ns, ms, ctx.windows)

    # sweep3d: the linked subset, first sweep of the fixed point
    keep, _ = fof.linked_mask(b3d)
    sub = fof.subset(keep).ctx
    lab = torch.arange(sub.ns, device=pos.device, dtype=torch.int32)
    sw = sub.windows.clone()
    sw[zero_blocks.clamp(max=sw.shape[0] - 1)] = 0
    got = KF.sweep3d(sub.pos, lab, sw, b2)
    want = KF.sweep3d_ref(sub.pos, lab, sw, KF.f32(b2))
    if not torch.equal(got, want):
        raise AssertionError("sweep3d kernel disagrees with sweep3d_ref: "
                             f"{int((got != want).sum())} rows")
    ms = cuda_ms(torch, lambda: KF.sweep3d(sub.pos, lab, sub.windows, b2))
    pms = wall_ms(torch, lambda: KF.sweep3d_ref(sub.pos, lab, sub.windows,
                                                KF.f32(b2)))
    entry("fof_sweep3d", fof_src,
          "velociraptor_stf_tpu/ops/pallas_fof.py:578", 0, ms, pms, sub.ns,
          sub.ns, ms, sub.windows)

    # sweep6d: the 3DFOF-tagged subset with the bench's velocity scale
    minsize = opt.HaloMinSize if opt.HaloMinSize > 0 else opt.MinSize
    sub3 = fof.subset(keep)
    pfof3, ng3 = sub3.fof3d(b3d, minsize)
    vs = halos.velocity_scales(opt, vel, mass, pfof3, ng3)
    c6 = sub3.subset(pfof3 > 0).ctx
    grp = pfof3[c6.src].int().contiguous()
    rivs = 1.0 / torch.clamp_min(vs[c6.src], 1e-30)
    vel6 = vel[c6.src].T.contiguous()
    inv_b2 = 1.0 / (b3d * opt.ellhalo6dxfac) ** 2
    lab = torch.arange(c6.ns, device=pos.device, dtype=torch.int32)
    w6 = c6.windows.clone()
    w6[zero_blocks.clamp(max=w6.shape[0] - 1)] = 0
    got = KF.sweep6d(c6.pos, vel6, rivs, grp, lab, w6, inv_b2)
    want = KF.sweep6d_ref(c6.pos, vel6, rivs, grp, lab, w6, KF.f32(inv_b2))
    if not torch.equal(got, want):
        raise AssertionError("sweep6d kernel disagrees with sweep6d_ref: "
                             f"{int((got != want).sum())} rows")
    ms = cuda_ms(torch, lambda: KF.sweep6d(c6.pos, vel6, rivs, grp, lab,
                                           c6.windows, inv_b2))
    pms = wall_ms(torch, lambda: KF.sweep6d_ref(
        c6.pos, vel6, rivs, grp, lab, c6.windows, KF.f32(inv_b2)))
    entry("fof_sweep6d", fof_src,
          "velociraptor_stf_tpu/ops/pallas_fof.py:680", 0, ms, pms, c6.ns,
          c6.ns, ms, c6.windows)

    # potential: the full box sorted by 6DFOF group -- untagged (gid 0)
    # blocks first, the last group at the array tail -- as compute_potential
    # lays it out
    pfof6 = halos.search_full_set(opt, pos, vel, mass, BOXSIZE).pfof
    ng6 = int(pfof6.max())
    upos = seg.unwrap_positions(pos, pfof6, BOXSIZE, ng6)
    perm = seg.sort_by_group(pfof6)
    g_s = pfof6[perm]
    offsets = seg.group_offsets(g_s, ng6)
    pos_s = upos[perm].T.contiguous()
    mass_s = mass[perm].contiguous()
    gid_s = g_s.int().contiguous()
    pw = gravity_direct.block_window(g_s, offsets)
    eps2 = KP.f32(opt.uinfo.eps ** 2)
    nb = pw.shape[0]
    if int(pw[0, 0, 1]) != 0:
        raise AssertionError("potential: expected a gid-0 block first")
    # the plain version runs on a row sample: the first (gid 0) and last
    # (the array tail) blocks, some gid-0 blocks, and 1024 blocks spread
    # over the tagged ones (each scans its groups' full windows)
    has = (pw[:, 0, 1] > 0).cpu().numpy()
    tagged, empty = np.nonzero(has)[0], np.nonzero(~has)[0]
    blocks = np.unique(np.concatenate([
        np.arange(min(4, nb)), np.arange(max(nb - 4, 0), nb),
        empty[np.linspace(0, len(empty) - 1, 16).astype(np.int64)],
        tagged[np.linspace(0, len(tagged) - 1, 1024).astype(np.int64)]]))
    blocks = torch.from_numpy(blocks).to(pos.device)
    got = KP.potential(pos_s, mass_s, gid_s, pw, eps2)
    want = KP.potential_ref(pos_s, mass_s, gid_s, pw, eps2, blocks=blocks)
    rows = (blocks[:, None] * R_BLOCK +
            torch.arange(R_BLOCK, device=pos.device)[None, :]).ravel()
    rows = rows[rows < pos_s.shape[1]]
    g_r, w_r = got[rows].double(), want[rows].double()
    if not bool(torch.isfinite(g_r).all()):
        raise AssertionError("potential: non-finite values")
    err = (g_r - w_r).abs()
    nz = w_r != 0
    rel = float((err[nz] / w_r[nz].abs()).max()) if bool(nz.any()) else 0.0
    if rel >= POT_RTOL or bool((g_r[~nz] != 0).any()):
        raise AssertionError(f"potential kernel disagrees: rel {rel}")
    log(f"potential: {int(nz.sum())} nonzero rows compared, max rel {rel}")
    ms = cuda_ms(torch, lambda: KP.potential(pos_s, mass_s, gid_s, pw,
                                             eps2))
    sub_w = torch.zeros_like(pw)
    sub_w[blocks] = pw[blocks]
    ms_sub = cuda_ms(torch, lambda: KP.potential(pos_s, mass_s, gid_s,
                                                 sub_w, eps2))
    pms = wall_ms(torch, lambda: KP.potential_ref(
        pos_s, mass_s, gid_s, pw, eps2, blocks=blocks))
    entry("potential", "velociraptor_stf_tpu_torch/kernels/csrc/"
          "potential.cu", "velociraptor_stf_tpu/ops/pallas_gravity.py:40",
          float(err.max()), ms, pms, pos_s.shape[1], int(rows.shape[0]),
          ms_sub, pw)


def check_catalog(np, res, n: int, minsize: int) -> None:
    """Finite energies; ids 1..ngroups, each at least minsize, numbered by
    decreasing size; properties of ngroups + 1 rows, the bulk ones
    finite."""
    if res.pfof.shape != (n,) or res.W is None or res.W.shape != (n,):
        raise AssertionError("main path: wrong output shapes")
    if not np.isfinite(res.W).all():
        raise AssertionError("main path: non-finite W")
    if res.ngroups <= 0:
        raise AssertionError("main path: no groups")
    sizes = np.bincount(res.pfof, minlength=res.ngroups + 1)
    if sizes.shape[0] != res.ngroups + 1:
        raise AssertionError("main path: group id above ngroups")
    s = sizes[1:]
    if (s < minsize).any() or (s[1:] > s[:-1]).any():
        raise AssertionError("main path: groups not renumbered by size")
    for k, v in res.props.items():
        if v.shape[0] != res.ngroups + 1:
            raise AssertionError(f"main path: property {k} has "
                                 f"{v.shape[0]} rows")
    # member-only SO extrapolations may overflow (as in the reference);
    # the bulk properties may not
    for k in ("num", "gmass", "gcm", "gcmvel", "gsize", "gRhalfmass",
              "gmaxvel", "gveldisp", "gJ", "Efrac", "Epot", "Mass_profile"):
        if not np.isfinite(res.props[k]).all():
            raise AssertionError(f"main path: property {k} not finite")


def same_catalog(np, a, b) -> bool:
    """Two catalogs equal bit for bit: group ids, potentials, every
    property array."""
    if not (np.array_equal(a.pfof, b.pfof) and np.array_equal(a.W, b.W)
            and set(a.props) == set(b.props)):
        return False
    return all(np.array_equal(a.props[k], b.props[k]) for k in a.props)


def check_properties(np, res, pos, mass, boxsize: float) -> int:
    """Phase 5: every group's size, mass and centre against float64
    numpy on the returned group ids (centres of positions unwrapped about
    each group's lowest-index member, as the port unwraps them)."""
    ng = res.ngroups
    pfof = res.pfof.astype(np.int64)
    num = np.bincount(pfof, minlength=ng + 1)
    m64 = mass.astype(np.float64)
    gmass = np.bincount(pfof, weights=m64, minlength=ng + 1)
    order = np.argsort(pfof, kind="stable")
    first = order[np.searchsorted(pfof[order], np.arange(ng + 1))]
    ref = pos[first[pfof]].astype(np.float64)
    d = pos.astype(np.float64) - ref
    d -= boxsize * np.round(d / boxsize)
    upos = ref + d
    gcm = np.stack([np.bincount(pfof, weights=m64 * upos[:, k],
                                minlength=ng + 1) for k in range(3)], 1)
    gcm /= np.maximum(gmass, 1e-30)[:, None]
    if not np.array_equal(res.props["num"][1:], num[1:]):
        raise AssertionError("properties: group sizes differ from numpy")
    rel_m = np.abs(res.props["gmass"][1:] - gmass[1:]) / gmass[1:]
    scale = np.maximum(np.abs(gcm[1:]).max(1), 1e-30)
    rel_c = np.abs(res.props["gcm"][1:] - gcm[1:]).max(1) / scale
    if rel_m.max() > 1e-5 or rel_c.max() > 1e-5:
        raise AssertionError(f"properties: mass rel {rel_m.max()}, centre "
                             f"rel {rel_c.max()} (limit 1e-5)")
    return ng


def plummer_case(torch, np, dev, oracles):
    """tests/test_oracles.py:36-65 through the port's compute_properties
    on the card: SO masses and radii within 5e-3 of the float64 oracle."""
    from velociraptor_stf_tpu_torch.models import properties

    rng = np.random.default_rng(50)
    n, a, mtot, rhocrit = 20000, 0.5, 1000.0, 0.1
    r = a / np.sqrt(rng.uniform(0.05, 1.0, n) ** (-2 / 3) - 1.0 + 1e-9)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = r[:, None] * u
    vel = rng.normal(0, 1.0, (n, 3)) * 0.3 * np.sqrt(mtot / n)
    mass = np.full(n, mtot / n)
    pr = properties.compute_properties(
        *(torch.from_numpy(x.astype(np.float32)).to(dev)
          for x in (pos, vel, mass)),
        torch.ones(n, dtype=torch.int64, device=dev), 1, rhocrit=rhocrit,
        rhobg=0.3 * rhocrit, iIterateCM=False, min_size=20)
    cm = np.sum(pos * mass[:, None], 0) / mass.sum()
    thr = [np.log(200.0 * rhocrit), np.log(500.0 * rhocrit),
           np.log(200.0 * 0.3 * rhocrit)]
    (R200c, R500c, R200m), (M200c, M500c, M200m) = oracles.so_oracle(
        np.linalg.norm(pos - cm, axis=1), mass, thr,
        max(int(0.05 * n + 1), int(20 * 0.05 + 1)))
    worst = 0.0
    for key, want in (("gM200c", M200c), ("gM500c", M500c),
                      ("gM200m", M200m), ("gR200c", R200c),
                      ("gR500c", R500c), ("gR200m", R200m)):
        rel = abs(float(pr[key][1]) - want) / want
        if not want > 0 or rel >= 5e-3:
            raise AssertionError(f"Plummer case: {key} rel {rel}")
        worst = max(worst, rel)
    return worst


def analytic_so_case(torch, np, dev):
    """tests/test_so.py:33-48 through the port's so_masses_all_particles
    on the card: R within 3%, M within 4% of the analytic crossing."""
    from velociraptor_stf_tpu_torch.ops import so

    rng = np.random.default_rng(1)
    n_h, n_bg, box, Rh, rt = 20000, 40000, 10.0, 0.5, 0.35
    centre = np.array([5.0, 5.0, 5.0])
    r = Rh * rng.random(n_h)
    d = rng.normal(size=(n_h, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = np.concatenate([centre + d * r[:, None],
                          rng.random((n_bg, 3)) * box]).astype(np.float32)
    vol = 4 / 3 * math.pi * rt ** 3
    M_true = n_h * rt / Rh + vol * n_bg / box ** 3
    M, R = so.so_masses_all_particles(
        torch.from_numpy(pos).to(dev),
        torch.ones(len(pos), dtype=torch.float32, device=dev),
        centre[None, :], np.array([2.0]), [math.log(M_true / vol)],
        boxsize=box, minnum=np.array([8]), first_mass=np.array([1.0]))
    rel_r, rel_m = abs(R[0, 0] / rt - 1), abs(M[0, 0] / M_true - 1)
    if rel_r >= 0.03 or rel_m >= 0.04:
        raise AssertionError(f"analytic SO case: R rel {rel_r}, M rel "
                             f"{rel_m}")
    return rel_r, rel_m


def _binary(np, path: Path, counts: int):
    """(header counts, payload bytes) of a binary catalog file: int32
    task and nprocs, then ``counts`` uint64 counts."""
    buf = path.read_bytes()
    head = np.frombuffer(buf, np.int32, 2)
    if tuple(head) != (0, 1):
        raise AssertionError(f"{path.name}: bad header {head}")
    return np.frombuffer(buf, np.uint64, counts, 8).astype(np.int64), \
        buf[8 + 8 * counts:]


def check_cli_files(np, out: str, ng: int, npart: int, nedges: int) -> None:
    """Parse the binary .properties, .catalog_groups, .catalog_particles,
    .hierarchy and .profiles of ``out`` and hold them to ``ng`` groups."""
    buf = Path(out + ".properties").read_bytes()
    if tuple(np.frombuffer(buf, np.int32, 2)) != (0, 1):
        raise AssertionError(".properties: bad header")
    counts = np.frombuffer(buf, np.uint64, 2, 8)
    ncols = int(np.frombuffer(buf, np.int32, 1, 24)[0])
    body = len(buf) - 28
    if tuple(counts) != (ng, ng) or body % max(ng, 1) or \
            not 8 * ncols - 4 <= body // ng <= 8 * ncols:
        raise AssertionError(f".properties: {counts} groups, {ncols} "
                             f"columns, {body} bytes for {ng} groups")
    ids = np.frombuffer(buf, np.uint8, body, 28).reshape(ng, -1)[:, :8]
    ids = ids.copy().view(np.int64).ravel()
    if not np.array_equal(ids - ids[0], np.arange(ng)):
        raise AssertionError(".properties: halo ids not consecutive")
    (c, _), rest = _binary(np, Path(out + ".catalog_groups"), 2)
    if c != ng or len(rest) != 24 * ng:
        raise AssertionError(f".catalog_groups: {c} groups")
    sizes, offs, _ = np.frombuffer(rest, np.int64).reshape(3, ng)
    if (sizes < 1).any() or not np.array_equal(
            offs, np.concatenate([[0], np.cumsum(sizes)[:-1]])):
        raise AssertionError(".catalog_groups: sizes and offsets disagree")
    (npid, _), rest = _binary(np, Path(out + ".catalog_particles"), 2)
    pids = np.frombuffer(rest, np.int64)
    if npid != sizes.sum() or len(pids) != npid or pids.min() < 1 or \
            pids.max() > npart or len(np.unique(pids)) != npid:
        raise AssertionError(".catalog_particles: bad particle ids")
    (c, _), rest = _binary(np, Path(out + ".hierarchy"), 2)
    if c != ng or len(rest) != 16 * ng:
        raise AssertionError(f".hierarchy: {c} groups")
    hc, rest = _binary(np, Path(out + ".profiles"), 4)
    norm_nedges = np.frombuffer(rest, np.int32, 2)
    nb = nedges + 1
    if tuple(hc) != (ng,) * 4 or norm_nedges[1] != nedges or \
            len(rest) != 8 + 8 * nedges + 16 * ng * nb:
        raise AssertionError(".profiles: bad layout")
    npro = np.frombuffer(rest, np.int64, ng * nb,
                         8 + 8 * nedges + 8 * ng * nb).reshape(ng, nb)
    if (npro.sum(1) > sizes).any():
        raise AssertionError(".profiles: more particles than members")


def cli_case(torch, np, dev, C, n: int) -> str:
    """Phase 6: the CLI as a user runs it, on a gadget snapshot, against
    find_structures on the same snapshot."""
    from velociraptor_stf_tpu.io import gadget
    from velociraptor_stf_tpu.io.synthetic import make_cosmo_mock
    from velociraptor_stf_tpu_torch import cli
    from velociraptor_stf_tpu_torch.models.pipeline import find_structures

    tmp = Path(tempfile.mkdtemp(prefix="vr_cli_"))
    try:
        pos, vel, mass = make_cosmo_mock(n, boxsize=BOXSIZE,
                                         nhalos=max(64, n // 16384), seed=7)
        snap = tmp / "snap.gdt"
        gadget.write_gadget(str(snap), pos, vel, np.arange(1, len(pos) + 1),
                            np.ones(len(pos), np.int8), mass,
                            boxsize=BOXSIZE, time=1.0, omega0=0.3,
                            omega_lambda=0.7, hubble=1.0)
        del pos, vel, mass
        out = str(tmp / "catalog")
        cfg = write_slice_config(tmp / "run.cfg", out)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "velociraptor_stf_tpu_torch.cli", "-C",
             str(cfg), "-i", str(snap), "--device", dev.type],
            cwd=str(REPO), capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"CLI exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        # the same snapshot and options in this process
        opt = C.parse_config_file(str(cfg))
        opt.fname, opt.inputtype = str(snap), C.IOGADGET
        C.config_check(opt, strict=True)
        spos, svel, pids, _, smass, box, _ = cli.read_snapshot(opt)
        res = find_structures(opt, spos, svel, smass, boxsize=box,
                              device=dev)
        check_cli_files(np, out, res.ngroups, len(pids),
                        len(opt.profile_bin_edges))
        timeline = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("TIME::total")]
        return (f"{res.ngroups} groups in every file, CLI {wall:.1f} s "
                f"wall ({timeline[-1] if timeline else 'no TIME line'})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def tree_case(torch, np, dev, opt):
    """Phase 7: one group above MAX_DIRECT through compute_potential (the
    bucket tree) and the direct kernel; the tree's error against the
    direct sum and both times."""
    from velociraptor_stf_tpu_torch.models import unbind

    rng = np.random.default_rng(2)
    # tests/test_unbind.py:60-77 at TREE_N members: lognormal radii
    r = np.exp(rng.normal(-1.5, 1.0, TREE_N))
    d = rng.normal(size=(TREE_N, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = torch.from_numpy((r[:, None] * d).astype(np.float32)).to(dev)
    mass = torch.ones(TREE_N, dtype=torch.float32, device=dev)
    pfof = torch.ones(TREE_N, dtype=torch.int64, device=dev)
    if TREE_N <= unbind.MAX_DIRECT:
        raise AssertionError("tree case: the group must exceed MAX_DIRECT")
    times = {}
    out = {}
    for name, cut in (("direct", TREE_N), ("tree", unbind.MAX_DIRECT)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = unbind.compute_potential(pos, mass, pfof, 1,
                                             opt.uinfo.eps, opt.G,
                                             direct_cut=cut)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
    exact = out["direct"].double()
    if not bool(torch.isfinite(out["tree"]).all()):
        raise AssertionError("tree case: non-finite potentials")
    err = ((out["tree"].double() - exact).abs() / exact.abs()).cpu().numpy()
    med, p99 = float(np.median(err)), float(np.percentile(err, 99))
    if med >= 0.005 or p99 >= 0.03:
        raise AssertionError(f"tree case: median rel {med}, p99 {p99}")
    return times, med, p99


def profile_run(torch, opt, pos, vel, mass, dev, path: str) -> None:
    """One more find_structures run under torch.profiler: device time by
    operator (table to ``path``), the four kernels' share, and the
    device's idle share of the wall time, for the whole run and for the
    fof + unbind stages alone."""
    from torch.profiler import ProfilerActivity, profile

    from velociraptor_stf_tpu_torch.models.pipeline import (find_structures,
                                                           search_and_unbind)

    # inputs already on the card: the window holds the timed stages
    pos, vel, mass = (torch.from_numpy(a).to(dev) for a in (pos, vel, mass))
    for name, run in (("find_structures", find_structures),
                      ("search_and_unbind", search_and_unbind)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = run(opt, pos, vel, mass, boxsize=BOXSIZE, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        table = events.table(sort_by="self_device_time_total", row_limit=40)
        with open(path, "a") as f:
            f.write(f"{name}: timings {json.dumps(res.timings)} wall "
                    f"{wall:.6f} s\n{table}\n")
        # device-side events only (kernels, copies); the profiler's own
        # buffer requests are not work
        busy = {}
        for e in events:
            t = getattr(e, "self_device_time_total", 0.0)
            if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA \
                    and "Activity Buffer" not in e.key:
                busy[e.key] = t / 1e3
        total = sum(busy.values())
        ours = {k: v for k, v in busy.items() if "_kernel" in k and
                any(w in k for w in ("detect", "sweep3d", "sweep6d",
                                     "potential"))}
        log(f"profile {name}: wall {wall * 1e3:.3f} ms, device busy "
            f"{total:.3f} ms (idle share {1 - total / (wall * 1e3):.4f}), "
            f"the four kernels {json.dumps(ours)}; table in {path}")
        for k, v in sorted(busy.items(), key=lambda kv: -kv[1])[:12]:
            log(f"profile {name}: {v:12.3f} ms  {k[:100]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=256 ** 3,
                    help="particles of the main-path run (default 256^3)")
    ap.add_argument("--cli-n", type=int, default=128 ** 3,
                    help="particles of the CLI phase's snapshot "
                    "(default 128^3)")
    ap.add_argument("--profile", metavar="PATH",
                    help="after the checks, profile one more find_structures "
                    "and search_and_unbind run and append the device-time "
                    "tables by operator to PATH")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2

    import numpy as np

    from velociraptor_stf_tpu.io.synthetic import make_cosmo_mock
    from velociraptor_stf_tpu.utils import config as C
    from velociraptor_stf_tpu.utils import units
    from velociraptor_stf_tpu.validation import oracles
    from velociraptor_stf_tpu_torch import kernels
    from velociraptor_stf_tpu_torch.kernels import _build
    from velociraptor_stf_tpu_torch.models.pipeline import (find_structures,
                                                           search_and_unbind)

    dev = torch.device("cuda")
    card = card_info()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = _build.build()
    log(f"phase 1 build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    log(lib.with_suffix(".log").read_text().strip())

    n = args.n
    t0 = time.perf_counter()
    pos, vel, mass = make_cosmo_mock(n, boxsize=BOXSIZE,
                                     nhalos=max(64, n // 16384), seed=7)
    log(f"mock: n={n} ({len(pos)} particles) in "
        f"{time.perf_counter() - t0:.1f} s")
    opt = bench_options(n, C, BOXSIZE)
    units.calc_cosmo_params(opt, opt.a)
    tpos, tvel, tmass = (torch.from_numpy(a).to(dev)
                         for a in (pos, vel, mass))

    report: list = []
    t0 = time.perf_counter()
    check_kernels(torch, np, tpos, tvel, tmass, opt, report)
    log(f"phase 2 kernels vs plain: ok in {time.perf_counter() - t0:.1f} s")

    # phase 3: the small oracle case, exact partition
    t0 = time.perf_counter()
    on = 12 ** 3 * 8
    obox = 25.0
    opos, ovel, omass = make_cosmo_mock(on, boxsize=obox, nhalos=16,
                                        seed=11)
    oopt = bench_options(on, C, obox)
    ores = search_and_unbind(oopt, opos, ovel, omass, boxsize=obox,
                             device=dev)
    want, ng_want = oracle_chain(opos, ovel, omass,
                                 bench_options(on, C, obox), obox, oracles)
    got = ores.pfof.cpu().numpy()
    if ores.ngroups != ng_want or not np.array_equal(got, want):
        raise AssertionError(
            f"oracle case: ngroups {ores.ngroups} vs {ng_want}, "
            f"{int((got != want).sum())} particles differ")
    log(f"phase 3 oracle case: {ng_want} groups, exact partition, "
        f"{time.perf_counter() - t0:.1f} s")

    # phase 4: the main path at full size, twice
    minsize = opt.HaloMinSize if opt.HaloMinSize > 0 else opt.MinSize
    del tpos, tvel, tmass
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="vr_smoke_"))
    try:
        cfg = write_slice_config(tmp / "slice.cfg")
        first = None
        for rep in range(2):
            if rep == 1:
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launches()
            t0 = time.perf_counter()
            res = find_structures(slice_options(n, C, BOXSIZE, cfg), pos,
                                  vel, mass, boxsize=BOXSIZE, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(kernels.LAUNCHES)
            check_catalog(np, res, len(pos), minsize)
            if first is None:
                first = res
            elif not same_catalog(np, res, first):
                raise AssertionError("main path: two runs on the same input "
                                     "differ")
            metric = res.timings["fof"] + res.timings["unbind"]
            log(f"phase 4 run {rep} ({'warm-up' if rep == 0 else 'timed'}): "
                f"ngroups {res.ngroups} timings {json.dumps(res.timings)} "
                f"wall {wall:.3f} s fof+unbind {n / metric:.1f} particles/s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"launches {json.dumps(counts)} peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; two runs "
        f"equal bit for bit ({len(res.props)} property arrays)")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    for e in report:
        e["launches"] = counts[e["name"]]

    t0 = time.perf_counter()
    ng = check_properties(np, res, pos, mass, BOXSIZE)
    worst = plummer_case(torch, np, dev, oracles)
    rel_r, rel_m = analytic_so_case(torch, np, dev)
    log(f"phase 5 properties: {ng} groups' size, mass and centre agree with "
        f"float64 numpy; Plummer SO worst rel {worst:.3g}; analytic SO R "
        f"rel {rel_r:.3g} M rel {rel_m:.3g}; {time.perf_counter() - t0:.1f} s")
    del res, first

    t0 = time.perf_counter()
    msg = cli_case(torch, np, dev, C, args.cli_n)
    log(f"phase 6 CLI at n={args.cli_n}: {msg}; "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    times, med, p99 = tree_case(torch, np, dev, opt)
    log(f"phase 7 tree: one {TREE_N}-member group, tree {times['tree']:.3f} "
        f"s vs direct kernel {times['direct']:.3f} s; tree vs direct median "
        f"rel {med:.3g}, p99 {p99:.3g}; {time.perf_counter() - t0:.1f} s")
    if args.profile:
        tmp = Path(tempfile.mkdtemp(prefix="vr_smoke_"))
        try:
            profile_run(torch, slice_options(
                n, C, BOXSIZE, write_slice_config(tmp / "slice.cfg")),
                pos, vel, mass, dev, args.profile)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    log(f"gpu: {card}")
    log(json.dumps({"kernels": report}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
