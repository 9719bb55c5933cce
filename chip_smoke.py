#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--n N]

Builds the port's CUDA kernels from ``velociraptor_stf_tpu_torch/kernels/
csrc`` and drives its main path (``models.pipeline.search_and_unbind``:
3DFOF -> 6DFOF -> field unbind) on the card, in phases:

1. a CUDA device must be present (the script never falls back to the CPU);
2. each kernel against its plain PyTorch version, on the card, at the
   shapes the main path gives it: detect counts and sweep labels exactly
   equal, the potential within rel 1e-4; times of both;
3. the main path on the small oracle case of tests/test_oracles.py against
   the independent float64 oracle chain: the partition must be exact;
4. the main path at N = 256^3 (the bench's mock, seed 7, the bench's
   options), twice, the first time as warm-up; every kernel's launch count
   over the second run must be > 0, the catalog must be well formed and
   both runs must give the same group ids and potentials.

Any failure exits non-zero.  The last line of stdout is the JSON result
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

BOXSIZE = 100.0
POT_RTOL = 1e-4


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


def check_catalog(torch, res, n: int, minsize: int) -> None:
    """Finite energies; ids 1..ngroups, each at least minsize, numbered by
    decreasing size."""
    if tuple(res.pfof.shape) != (n,) or res.W is None or \
            tuple(res.W.shape) != (n,):
        raise AssertionError("main path: wrong output shapes")
    if not bool(torch.isfinite(res.W).all()):
        raise AssertionError("main path: non-finite W")
    if res.ngroups <= 0:
        raise AssertionError("main path: no groups")
    sizes = torch.bincount(res.pfof, minlength=res.ngroups + 1)
    if sizes.shape[0] != res.ngroups + 1:
        raise AssertionError("main path: group id above ngroups")
    s = sizes[1:]
    if bool((s < minsize).any()) or bool((s[1:] > s[:-1]).any()):
        raise AssertionError("main path: groups not renumbered by size")


def profile_run(torch, opt, pos, vel, mass, dev, path: str) -> None:
    """One more main-path run under torch.profiler: device time by
    operator (table to ``path``), the four kernels' share, and the device's
    idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from velociraptor_stf_tpu_torch.models.pipeline import search_and_unbind

    # inputs already on the card: the window holds the two timed stages
    pos, vel, mass = (torch.from_numpy(a).to(dev) for a in (pos, vel, mass))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = search_and_unbind(opt, pos, vel, mass, boxsize=BOXSIZE,
                                device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    with open(path, "w") as f:
        f.write(f"timings {json.dumps(res.timings)} wall {wall:.6f} s\n")
        f.write(table + "\n")
    # device-side events only (kernels, copies); the profiler's own
    # buffer requests are not work
    busy = {}
    for e in events:
        t = getattr(e, "self_device_time_total", 0.0)
        if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA and \
                "Activity Buffer" not in e.key:
            busy[e.key] = t / 1e3
    total = sum(busy.values())
    ours = {k: v for k, v in busy.items() if "_kernel" in k and
            any(w in k for w in ("detect", "sweep3d", "sweep6d",
                                 "potential"))}
    log(f"profile: wall {wall * 1e3:.3f} ms, device busy {total:.3f} ms "
        f"(idle share {1 - total / (wall * 1e3):.4f}), the four kernels "
        f"{json.dumps(ours)}; table in {path}")
    for k, v in sorted(busy.items(), key=lambda kv: -kv[1])[:12]:
        log(f"profile: {v:12.3f} ms  {k[:100]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=256 ** 3,
                    help="particles of the main-path run (default 256^3)")
    ap.add_argument("--profile", metavar="PATH",
                    help="after the checks, profile one more main-path run "
                    "and write the device-time table by operator to PATH")
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
    from velociraptor_stf_tpu_torch.models.pipeline import search_and_unbind

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
    first = None
    for rep in range(2):
        if rep == 1:
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
        t0 = time.perf_counter()
        res = search_and_unbind(bench_options(n, C, BOXSIZE), pos, vel, mass,
                                boxsize=BOXSIZE, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
        check_catalog(torch, res, len(pos), minsize)
        if first is None:
            first = res
        elif not (torch.equal(res.pfof, first.pfof) and
                  torch.equal(res.W, first.W)):
            raise AssertionError("main path: two runs on the same input "
                                 "differ")
        metric = res.timings["fof"] + res.timings["unbind"]
        log(f"phase 4 run {rep} ({'warm-up' if rep == 0 else 'timed'}): "
            f"ngroups {res.ngroups} timings {json.dumps(res.timings)} "
            f"wall {wall:.3f} s fof+unbind {n / metric:.1f} particles/s")
    log(f"launches {json.dumps(counts)} peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    for e in report:
        e["launches"] = counts[e["name"]]
    if args.profile:
        profile_run(torch, bench_options(n, C, BOXSIZE), pos, vel, mass,
                    dev, args.profile)
    log(f"gpu: {card}")
    log(json.dumps({"kernels": report}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
