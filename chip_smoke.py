#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--n N] [--cli-n N]

Per-stage and per-span times, waits and launches of a catalog come from
the benchmark's traced run (``benchmark/run.py --trace 1``), not from
this script.

Builds the port's CUDA kernels from ``velociraptor_stf_tpu_torch/kernels/
csrc`` and drives the port on the card, in phases:

1. a CUDA device must be present (the script never falls back to the CPU);
   the kernels are built, and each one's lane-arithmetic instructions per
   pair are read from the library's SASS (``cuobjdump -sass``);
2. each kernel against its plain PyTorch version, on the card, at the
   shapes the main path gives it: detect counts and sweep labels exactly
   equal (z-columns emptied in detect's index and rows whose windows are
   zeroed included), the potential within
   rel 1e-4 (and on a small case at the edges of its launch geometry,
   with eps2 = 0 and a coincident pair); times of both, the time to build
   detect's column index and each subset's cell windows, pairs tested and
   needed, each kernel's registers and spills, and the bound: the
   larger of the bytes over the memory rate and the needed pairs'
   operations over their pipe's rate.  The bytes are the function's own
   inputs and outputs, never a kernel's index tables.  A FOF kernel needs
   the pairs of each row's 27 cells (of the same 3DFOF group for the 6D
   sweep), at its SASS instructions per pair over the issue rate (for a
   sweep, the fewer of its own and the function's arithmetic,
   ``SWEEP_OPS_PER_PAIR``, so that spending more instructions a pair
   cannot raise its bound); the sweeps must test at most 1.05x the pairs
   they need, and their lane efficiency is modelled from the rows' window
   lengths, not measured; the potential needs sum s (s - 1) rsqrts on the
   MUFU (and half that under the pair symmetry, printed beside it);
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
   bit; the peak device memory of the run and of the field search alone;
5. properties on the card: every group's size, mass and centre against a
   float64 numpy recomputation from the returned group ids (counts exact,
   rel 1e-5); the Plummer halo of tests/test_oracles.py against the
   float64 SO oracle (5e-3); the analytic SO case of tests/test_so.py
   (R within 3%, M within 4%);
6. the CLI, ``python -m velociraptor_stf_tpu_torch.cli``, on a 128^3
   gadget snapshot with binary output (the card's machine has no h5py):
   the catalog files must parse and hold find_structures' group count on
   the same snapshot; then the library API on the same particles as
   tensors on the card (``api.VelociraptorSession.invoke``): the same
   group ids, and with ``write_output`` the CLI's ``.catalog_groups``
   bytes;
7. the bucket tree: one 1,200,000-member group (above ``MAX_DIRECT``)
   through ``compute_potential`` (the tree) and through the direct kernel;
   the JAX package's tree tolerance against the exact sum (median rel
   error < 0.005, 99th percentile < 0.03); times of both;
8. the hydro path at 256^3 (every 6th particle a baryon, the baryon
   search on), twice: launches, peak memory, equal runs, the catalog and
   the association against float64 numpy, the plain versions' ids at
   2^18;
9. the substructure path: find_structures at 256^3 with the bench's
   search options, the substructure search (``VR_BENCH_SUBSTRUCTURE=1``)
   and the sample config's substructure and merger-core blocks, twice:
   stage times and the recursion's laps, structures searched and
   substructures found per level, cores promoted, launches, peak memory;
   both runs equal bit for bit, the hierarchy consistent, every member of
   a top-level structure bound; in the first run every structure of a
   level's subset search (``search_subset_batch``) and core search
   (``search_cores_batch``) is searched again alone, as a batch of one:
   ids and counts exactly equal, so a structure's ids do not depend on
   the structures batched with it; every structure searched must be so
   checked, with the batches and pairs printed beside the ``subset`` and
   ``cores`` laps; then
   three planted hosts with subhalos through find_structures on the card
   and on the CPU: equal ids and hierarchy, at least two substructures;
10. the mesh path (``velociraptor_stf_tpu_torch/parallel``): find_structures
   with ``mesh=`` four shards on one card (and over every card when there
   are several) at 256^3 with phase 4's options, twice: against phase 4's
   catalog the 3DFOF ids, group count and ids (so the bound masks) equal,
   gmass / gM200c / gR200c / gMvir within rtol 1e-6 (a differing
   particle is printed with its bound and 6D margins), both runs equal
   bit for bit; stage times, per-shard loads and candidate pairs, the
   collectives by stage and kind (checked as the audit test checks
   them), the potential's launches under the mesh (``launches_mesh`` in
   the kernel JSON, > 0), peak memory; then the hydro and substructure
   paths at 128^3 and the planted subhalos, mesh against one card (ids,
   hierarchy and association equal), the substructure path with the
   density sharded (field structures equal), and the sharded density
   against one card's on the JAX test's statistics at 2^20 particles;
11. every runnable config under ``examples/`` as a user runs it
   (``cli.run`` after ``main``'s parsing and checks, binary catalogs; the
   swift 3DFOF config through ``api.VelociraptorSession.invoke`` with
   tensors on the card) on ``io/synthetic.py::example_snapshot`` at 128^3
   uniform particles plus 64 planted hosts with subhalos and 256 small
   halos (gas copies for the hydro configs, low-resolution particles for
   the zoom one): stage times, group and substructure counts, peak
   memory; every kernel launched over the six runs; the catalog, the
   hierarchy, boundness where the config unbinds, the sampled baryon
   association and the catalog files; for genesis the inclusive masses'
   pre-splice ids and a mesh of four shards on the card equal to one
   card; each config's ids and hierarchy on the CPU tests' input equal
   on the card and in the plain versions on the host;
   ``sample_zoom_run.cfg`` refused.

Any failure exits non-zero.  The last line of stdout is the JSON result
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

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
# phase 9: the slice's options with the substructure search on (bench.py's
# VR_BENCH_SUBSTRUCTURE=1 variant); the sample config brings its
# substructure and merger-core blocks
SUB_OVERRIDES = """
Search_for_substructure=1
Iterative_searchflag=1
"""
# Peak rates of one H100 SXM (NVIDIA's data sheet): 67 TFLOP/s float32 on
# the CUDA cores, i.e. 132 SMs x 128 FP32 lanes x 2 (FMA) x 1.98 GHz, and
# 3.35 TB/s of device memory.  At the same clock an SM's four schedulers
# issue one 32-lane instruction each per clock (the FP32 pipe's 128 lanes),
# and the MUFU (special function unit) evaluates 16 lanes per SM per clock.
CLOCK_HZ = 1.98e9
LANES_PER_S = 132 * 128 * CLOCK_HZ           # 3.35e13 lane-instructions/s
MUFU_LANES_PER_S = 132 * 16 * CLOCK_HZ       # 4.18e12 rsqrt/s
MEM_BYTES_PER_S = 3.35e12
# each kernel's hot loop holds one of these per pair (a float compare in
# the FOF kernels, the rsqrt in the potential)
PAIR_OP = {"fof_detect": "FSETP", "fof_sweep3d": "FSETP",
           "fof_sweep6d": "FSETP", "potential": "MUFU"}
# lane operations a linking test needs per pair, by the function's own
# arithmetic: d2 from coordinate differences (3 subtractions, 3 products,
# 2 sums) and its compare in detect and the 3D sweep; in 6D d2 and dv2,
# d2*inv_b2 + dv2*rivs
# (2 products, a sum), its compare and the group compare
FOF_OPS_PER_PAIR = {"fof_detect": 9, "fof_sweep3d": 9, "fof_sweep6d": 21}
FOF_MAX_EXCESS = 1.05       # pairs tested / needed allowed to a FOF kernel
# SASS that is no lane arithmetic: loads and stores, branches and
# convergence barriers; uniform-datapath instructions (U*) run once a warp
NOT_LANE_ARITH = ("LD", "ST", "BRA", "BSSY", "BSYNC", "BAR", "EXIT", "NOP",
                  "DEPBAR", "U")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sass_per_pair(lib: Path) -> dict:
    """Lane-arithmetic SASS instructions per pair of each kernel, read from
    the built library (``cuobjdump -sass``).  In the kernel's innermost
    loop (a backward branch with none inside) with the most ``PAIR_OP``
    instructions -- its unrolled scan -- every instruction that is not in
    ``NOT_LANE_ARITH`` (``PAIR_OP`` itself excluded for the potential,
    whose rsqrt goes to the MUFU), over the count of ``PAIR_OP``:
    {kernel: (instructions per pair, the loop's instructions, pairs)}."""
    import re
    from collections import Counter

    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or str(Path(home) / "bin" / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    line = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)([^;]*);")
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split(None, 1)[0]
        key = next((k for k, v in KERNEL_OF.items() if v in name), None)
        if key is None:
            continue
        code = [(int(m[1], 16), m[2].split(".")[0], m[3])
                for m in line.finditer(func)]
        back = [(int(re.search(r"0x([0-9a-f]+)", a)[1], 16), at)
                for at, op, a in code if op == "BRA" and "0x" in a]
        back = [(t, at) for t, at in back if t < at]
        inner = [(t, at) for t, at in back
                 if not any(t <= t2 and a2 < at for t2, a2 in back
                            if (t2, a2) != (t, at))]
        best = None
        for t, at in inner:
            ops = Counter(op for a, op, _ in code if t <= a <= at)
            if best is None or ops[PAIR_OP[key]] > best[PAIR_OP[key]]:
                best = ops
        pairs = best[PAIR_OP[key]] if best else 0
        if pairs == 0:
            raise AssertionError(f"SASS: no {PAIR_OP[key]} in a loop of "
                                 f"{name}")
        arith = sum(n for op, n in best.items()
                    if op != "MUFU" and not op.startswith(NOT_LANE_ARITH))
        out[key] = (arith / pairs, sum(best.values()), pairs)
    if set(out) != set(PAIR_OP):
        raise AssertionError(f"SASS: kernels found {sorted(out)}")
    return out


KERNEL_OF = {"fof_detect": "detect_kernel", "fof_sweep3d": "sweep3d_kernel",
             "fof_sweep6d": "sweep6d_kernel", "potential": "potential_kernel"}


def ptxas_report(log_text: str) -> dict:
    """{kernel: (registers, spill bytes stored + loaded)} from the build's
    ``-Xptxas -v`` output."""
    import re

    out = {}
    blocks = re.split(r"Compiling entry function '", log_text)[1:]
    for block in blocks:
        key = next((k for k, v in KERNEL_OF.items()
                    if v in block.split("'", 1)[0]), None)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        if key is not None and regs and spill:
            out[key] = (int(regs[1]), int(spill[1]) + int(spill[2]))
    if set(out) != set(KERNEL_OF):
        raise AssertionError(f"ptxas: kernels found {sorted(out)}")
    return out


def stencil_pairs(cx, cr, ncells, grp=None) -> int:
    """Pairs a cell-list FOF needs on the cell-sorted slots (x cell ``cx``,
    ``cr`` = y cell * nz + z cell): the sum over rows of the slots in the 27
    cells around the row's cell, the row included; with ``grp``, only rows
    of a nonzero group and columns of the same group."""
    import torch

    nx, ny, nz = ncells
    key = cx * (ny * nz) + cr
    if grp is not None:
        keep = grp > 0
        key = grp[keep].long() * (nx * ny * nz) + key[keep]
    cells, occ = torch.unique(key, return_counts=True)
    base = cells - cells % (nx * ny * nz)
    cell = cells % (nx * ny * nz)
    x, y, z = cell // (ny * nz), cell // nz % ny, cell % nz
    total = 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                qx, qy, qz = x + dx, y + dy, z + dz
                inside = ((qx >= 0) & (qx < nx) & (qy >= 0) & (qy < ny) &
                          (qz >= 0) & (qz < nz))
                q = base + (qx * ny + qy) * nz + qz
                at = torch.searchsorted(cells, q).clamp_(max=len(cells) - 1)
                hit = inside & (cells[at] == q)
                total += int((occ * torch.where(hit, occ[at], 0)).sum())
    return total


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


def check_kernels(torch, np, pos, vel, mass, opt, sass, ptxas, report):
    """Phase 2: every kernel against its plain version at the main path's
    shapes on the 256^3 context; ``sass`` holds each kernel's instructions
    per pair (``sass_per_pair``), ``ptxas`` its registers and spill bytes
    (``ptxas_report``)."""
    from velociraptor_stf_tpu_torch.kernels import R_BLOCK
    from velociraptor_stf_tpu_torch.kernels import fof_sweep as KF
    from velociraptor_stf_tpu_torch.kernels import potential as KP
    from velociraptor_stf_tpu_torch.models import halos
    from velociraptor_stf_tpu_torch.ops import fof_sweep as TF
    from velociraptor_stf_tpu_torch.ops import gravity_direct
    from velociraptor_stf_tpu_torch.ops import segments as seg
    from velociraptor_stf_tpu_torch.ops.fof_sweep import SweepFof

    b3d = opt.ellphys * opt.ellxscale * opt.ellhalophysfac
    reach = b3d * max(1.0, opt.ellhalo6dxfac)
    b2 = b3d * b3d
    fof = SweepFof(pos, vel, BOXSIZE, reach)
    ctx = fof.ctx
    def row_lengths(cell, win):
        """(ns,) columns each row of a sweep scans: its cell's windows."""
        return win[:, :, 1].long().sum(1)[cell.long()]

    def lane_efficiency(length):
        """Busy share of the lanes of warps of 32 consecutive rows, each
        lane running its row's loop, the warp its longest row's: a model
        from the rows' window lengths, not a measurement."""
        pad = torch.zeros(-(-length.shape[0] // 32) * 32, dtype=length.dtype,
                          device=length.device)
        pad[:length.shape[0]] = length
        return float(pad.sum()) / max(32 * float(pad.view(-1, 32).amax(1)
                                                 .sum()), 1.0)

    def zeroed(cell, win):
        """(windows with the cells of rows 0, ns/2 and ns - 1 emptied, those
        rows): such rows must keep their own label."""
        rows = torch.tensor([0, cell.shape[0] // 2, cell.shape[0] - 1],
                            device=cell.device)
        w = win.clone()
        w[cell[rows].long()] = 0
        return w, rows

    def entry(name, source, replaces, err, ms, plain_ms, rows,
              plain_rows, ms_plain_rows, pairs, needed, bound_ops_ms,
              nbytes, **extra):
        """One kernel's report; the bound is the larger of ``nbytes``, the
        function's inputs read once and outputs written once, over the
        memory rate and ``bound_ops_ms``, the operations of the pairs it
        needs over their pipe's rate."""
        bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
        bound_ms = max(bytes_ms, bound_ops_ms)
        report.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": 0,
                       "max_abs_err": float(err), "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": ("bytes" if bytes_ms > bound_ops_ms
                                    else "operations"),
                       "library_ms": None, "share_of_bound": bound_ms / ms,
                       "rows": rows, "plain_rows": plain_rows,
                       "ms_plain_rows": ms_plain_rows,
                       "pairs_tested": pairs, "pairs_needed": needed,
                       "pairs_per_s": pairs / (ms * 1e-3),
                       "instr_per_pair": sass[name][0],
                       "registers": ptxas[name][0],
                       "spill_bytes": ptxas[name][1], **extra})
        log(f"kernel {name}: max_abs_err {err} kernel {ms:.3f} ms "
            f"({rows} rows, {pairs} pairs tested, {needed} needed, "
            f"{pairs / (ms * 1e-3):.4g}/s, {sass[name][0]:.4g} SASS "
            f"lane-instructions per pair), bound {bound_ms:.3f} ms "
            f"(share {bound_ms / ms:.3f}), plain {plain_ms:.3f} ms "
            f"({plain_rows} rows)")

    def fof_entry(name, err, ms, pms, ctx, nbytes, pairs, grp=None,
                  **extra):
        """A FOF kernel: the pairs it needs are those of each row's 27
        cells (of the same group for the 6D sweep), each at its SASS
        instructions per pair or the function's arithmetic, whichever is
        fewer, over the issue rate."""
        needed = stencil_pairs(ctx.cx, ctx.cr, ctx.ncells, grp)
        per_pair = min(sass[name][0], FOF_OPS_PER_PAIR[name])
        ops_ms = needed * per_pair / LANES_PER_S * 1e3
        log(f"kernel {name}: {sass[name][0]:.4g} SASS lane-instructions "
            f"per pair, {FOF_OPS_PER_PAIR[name]} operations in the "
            f"function's arithmetic; the bound takes {per_pair:.4g}; "
            f"{ptxas[name][0]} registers, {ptxas[name][1]} spill bytes")
        if pairs > FOF_MAX_EXCESS * needed:
            raise AssertionError(f"{name}: {pairs} pairs tested, over "
                                 f"{FOF_MAX_EXCESS}x the {needed} needed")
        entry(name, fof_src, FOF_REPLACES[name], err, ms, pms, ctx.ns,
              ctx.ns, ms, pairs, needed, ops_ms, nbytes,
              ops_per_pair_bound=per_pair, **extra)

    fof_src = "velociraptor_stf_tpu_torch/kernels/csrc/fof_sweep.cu"
    FOF_REPLACES = {
        "fof_detect": "velociraptor_stf_tpu/ops/pallas_fof.py:613",
        "fof_sweep3d": "velociraptor_stf_tpu/ops/pallas_fof.py:578",
        "fof_sweep6d": "velociraptor_stf_tpu/ops/pallas_fof.py:680"}

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    def sweep_windows(c):
        """The subset's cell windows, and the time to build them (ms, a
        second build after the one cached on the context)."""
        cell, win = c.sweep_windows
        build_ms = wall_ms(torch, lambda: TF.cell_windows(c.cx, c.cr,
                                                          c.ncells))
        length = row_lengths(cell, win)
        mean = float(length.double().mean())
        eff = lane_efficiency(length)
        log(f"cell windows of {c.ns} rows ({win.shape[0]} occupied cells): "
            f"built in {build_ms:.3f} ms; per row {mean:.2f} columns (max "
            f"{int(length.max())}); lane efficiency {eff:.3f} (modelled "
            "from the window lengths, not measured)")
        return cell, win, length, {
            "window_build_ms": build_ms, "occupied_cells": win.shape[0],
            "lane_efficiency_modelled": eff}

    # detect: the full context, as linked_mask runs it
    nx, ny, nz = ctx.ncells
    col, colstart = ctx.detect_index

    def packed():
        return KF.pack(ctx.pos.T, (ctx.cr % nz).int())

    dpts = packed()
    # z-columns emptied in the index give no count: with the last two
    # x-stripes emptied, the rows of the last stripe count nothing
    emptied = colstart.clone()
    emptied[(nx - 2) * ny:] = colstart[(nx - 2) * ny]
    got = KF.detect(dpts, col, emptied, ny, b2)
    want = KF.detect_ref(dpts, col, emptied, ny, KF.f32(b2))
    last = ctx.cx == nx - 1
    if not torch.equal(got, want):
        raise AssertionError("detect kernel disagrees with detect_ref on "
                             f"emptied z-columns: {int((got != want).sum())}"
                             " rows")
    if not bool(last.any()) or int(got[last].sum()) != 0:
        raise AssertionError("detect: rows whose z-columns are all empty "
                             "counted")
    got = KF.detect(dpts, col, colstart, ny, b2)
    want = KF.detect_ref(dpts, col, colstart, ny, KF.f32(b2))
    if not torch.equal(got, want):
        raise AssertionError("detect kernel disagrees with detect_ref: "
                             f"{int((got != want).sum())} rows")
    ms = cuda_ms(torch, lambda: KF.detect(dpts, col, colstart, ny, b2))
    pms = wall_ms(torch, lambda: KF.detect_ref(dpts, col, colstart, ny,
                                               KF.f32(b2)))
    # what the launch takes besides: the index and the packed rows (each a
    # second build)
    index_ms = wall_ms(torch, lambda: TF.column_index(ctx.cx, ctx.cr,
                                                      ctx.ncells))
    pack_ms = wall_ms(torch, packed)
    batch = 1 << 21
    tested = sum(int(KF.column_windows(dpts, col, colstart, ny, r0,
                                       min(r0 + batch, ctx.ns))[:, :, 1]
                     .sum()) for r0 in range(0, ctx.ns, batch))
    cells = int(torch.unique_consecutive(
        ctx.cx * (ny * nz) + ctx.cr).shape[0])
    columns = int((colstart[1:] > colstart[:-1]).sum())
    log(f"column index of {ctx.ns} rows ({cells} occupied cells, {columns} "
        f"occupied of {nx * ny} z-columns): {nbytes(col, colstart)} bytes "
        f"built in {index_ms:.3f} ms, packed rows {nbytes(dpts)} bytes in "
        f"{pack_ms:.3f} ms")
    # bytes: positions in, counts out
    fof_entry("fof_detect", 0, ms, pms, ctx, nbytes(ctx.pos, got), tested,
              index_build_ms=index_ms, index_bytes=nbytes(col, colstart),
              pack_ms=pack_ms, packed_bytes=nbytes(dpts),
              occupied_cells=cells,
              occupied_columns=columns, columns=nx * ny)
    del dpts, got, want, emptied

    # sweep3d: the linked subset, first sweep of the fixed point
    keep, _ = fof.linked_mask(b3d)
    sub3 = fof.subset(keep)
    sub = sub3.ctx
    cell, win, length, extra = sweep_windows(sub)
    pts = KF.pack(sub.pos.T)
    lab = torch.arange(sub.ns, device=pos.device, dtype=torch.int32)
    zw, zrows = zeroed(cell, win)
    got = KF.sweep3d(pts, lab, cell, zw, b2)
    want = KF.sweep3d_ref(pts, lab, cell, zw, KF.f32(b2))
    if not torch.equal(got, want):
        raise AssertionError("sweep3d kernel disagrees with sweep3d_ref: "
                             f"{int((got != want).sum())} rows")
    if not torch.equal(got[zrows], lab[zrows]):
        raise AssertionError("sweep3d: a row with no windows changed label")
    ms = cuda_ms(torch, lambda: KF.sweep3d(pts, lab, cell, win, b2))
    pms = wall_ms(torch, lambda: KF.sweep3d_ref(pts, lab, cell, win,
                                                KF.f32(b2)))
    # bytes: positions and labels in, labels out
    fof_entry("fof_sweep3d", 0, ms, pms, sub, nbytes(sub.pos, lab, got),
              int(length.sum()), **extra)

    # sweep6d: the 3DFOF-tagged subset with the bench's velocity scale
    minsize = opt.HaloMinSize if opt.HaloMinSize > 0 else opt.MinSize
    pfof3, ng3 = sub3.fof3d(b3d, minsize)
    vs = halos.velocity_scales(opt, vel, mass, pfof3, ng3)
    c6 = sub3.subset(pfof3 > 0).ctx
    del sub3, sub, pts, cell, win, zw
    grp = pfof3[c6.src].int()
    rivs = 1.0 / torch.clamp_min(vs[c6.src], 1e-30)
    cell, win, length, extra = sweep_windows(c6)
    v6 = vel[c6.src]
    pts = KF.pack(c6.pos.T, grp)
    vels = KF.pack(v6, rivs)
    inv_b2 = 1.0 / (b3d * opt.ellhalo6dxfac) ** 2
    lab = torch.arange(c6.ns, device=pos.device, dtype=torch.int32)
    zw, zrows = zeroed(cell, win)
    got = KF.sweep6d(pts, vels, lab, cell, zw, inv_b2)
    want = KF.sweep6d_ref(pts, vels, lab, cell, zw, KF.f32(inv_b2))
    if not torch.equal(got, want):
        raise AssertionError("sweep6d kernel disagrees with sweep6d_ref: "
                             f"{int((got != want).sum())} rows")
    if not torch.equal(got[zrows], lab[zrows]):
        raise AssertionError("sweep6d: a row with no windows changed label")
    ms = cuda_ms(torch, lambda: KF.sweep6d(pts, vels, lab, cell, win,
                                           inv_b2))
    pms = wall_ms(torch, lambda: KF.sweep6d_ref(pts, vels, lab, cell, win,
                                                KF.f32(inv_b2)))
    # bytes: positions, velocities, groups, scales and labels in, labels out
    fof_entry("fof_sweep6d", 0, ms, pms, c6,
              nbytes(c6.pos, v6, grp, rivs, lab, got), int(length.sum()),
              grp, **extra)
    del c6, v6, pts, vels, cell, win, zw

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
    if bool(pw[:R_BLOCK].any()):
        raise AssertionError("potential: expected a gid-0 block first")
    # the plain version runs on a row sample of R_BLOCK-row blocks: the
    # first (gid 0) and last (the array tail) blocks, some gid-0 blocks,
    # and 1024 blocks spread over the tagged ones (each scans its groups'
    # full ranges)
    span = KP.spans(pw, R_BLOCK)
    nb = span.shape[0]
    has = (span[:, 1] > span[:, 0]).cpu().numpy()
    tagged, empty = np.nonzero(has)[0], np.nonzero(~has)[0]
    blocks = np.unique(np.concatenate([
        np.arange(min(4, nb)), np.arange(max(nb - 4, 0), nb),
        empty[np.linspace(0, len(empty) - 1, 16).astype(np.int64)],
        tagged[np.linspace(0, len(tagged) - 1, 1024).astype(np.int64)]]))
    blocks = torch.from_numpy(blocks).to(pos.device)
    got = KP.potential(pos_s, mass_s, gid_s, pw, eps2)
    if not torch.equal(got, KP.potential(pos_s, mass_s, gid_s, pw, eps2)):
        raise AssertionError("potential: two launches differ")
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
    edge_rel = potential_edge_case(torch, pos.device)
    log(f"potential edge case (eps2 = 0 coincident pair, gid-0 blocks, "
        f"one-member and tail groups): max rel {edge_rel}")
    ms = cuda_ms(torch, lambda: KP.potential(pos_s, mass_s, gid_s, pw,
                                             eps2))
    sub_w = torch.zeros_like(pw)
    sub_w[rows] = pw[rows]
    ms_sub = cuda_ms(torch, lambda: KP.potential(pos_s, mass_s, gid_s,
                                                 sub_w, eps2))
    pms = wall_ms(torch, lambda: KP.potential_ref(
        pos_s, mass_s, gid_s, pw, eps2, blocks=blocks))
    # pairs needed: sum of s (s - 1) over the groups of the direct sum, one
    # rsqrt each on the MUFU, and the loop's other lane instructions over
    # the issue rate; this assumes no use of the symmetry r_ij = r_ji,
    # under which the function needs half as many rsqrts ("symmetric")
    sizes = torch.bincount(g_s[g_s > 0]).double()
    needed = int((sizes * (sizes - 1)).sum())
    ops_ms = max(needed / MUFU_LANES_PER_S,
                 needed * sass["potential"][0] / LANES_PER_S) * 1e3
    # bytes: positions, masses and group ids in, potentials out
    pot_bytes = nbytes(pos_s, mass_s, gid_s, got)
    sym_ms = max(ops_ms / 2, pot_bytes / MEM_BYTES_PER_S * 1e3)
    entry("potential", "velociraptor_stf_tpu_torch/kernels/csrc/"
          "potential.cu", "velociraptor_stf_tpu/ops/pallas_gravity.py:40",
          float(err.max()), ms, pms, pos_s.shape[1], int(rows.shape[0]),
          ms_sub, KP.pairs_tested(pw), needed, ops_ms,
          pot_bytes, pairs_needed_symmetric=needed // 2,
          bound_ms_symmetric=sym_ms, share_of_bound_symmetric=sym_ms / ms)
    log(f"kernel potential: under the symmetric count ({needed // 2} "
        f"pairs) bound {sym_ms:.3f} ms, share {sym_ms / ms:.3f}")


def potential_edge_case(torch, dev) -> float:
    """The potential kernel at the edges of its launch geometry
    (``kernels/potential.py::edge_case``: gid-0 runs and whole gid-0 blocks,
    one- to three-member groups, groups straddling thread and block edges,
    a coincident pair in the group at the array tail) against its plain
    version, with eps2 = 0 (+inf must stay +inf) and eps2 > 0.  Exact zeros
    on gid-0 rows, rel 1e-4 elsewhere; returns the largest rel error."""
    from velociraptor_stf_tpu_torch.kernels import potential as KP
    from velociraptor_stf_tpu_torch.ops import gravity_direct

    pos, mass, g, offsets = KP.edge_case()
    gt = g.to(dev)
    args = (pos.T.contiguous().to(dev), mass.to(dev), gt.int(),
            gravity_direct.block_window(gt, offsets.to(dev)))
    worst = 0.0
    for eps2 in (0.0, 1e-4):
        got = KP.potential(*args, KP.f32(eps2)).double()
        want = KP.potential_ref(*args, KP.f32(eps2)).double()
        inf = torch.isinf(want)
        if bool(inf.any()) != (eps2 == 0.0) or \
                not torch.equal(got[inf], want[inf]):
            raise AssertionError(f"potential edge case: +inf not kept "
                                 f"(eps2 {eps2})")
        zero = want == 0
        if not bool((got[(gt == 0) | zero] == 0).all()):
            raise AssertionError("potential edge case: a gid-0 or lone row "
                                 "is not exactly 0")
        nz = ~zero & ~inf
        rel = float(((got - want)[nz] / want[nz]).abs().max())
        if not rel < POT_RTOL:
            raise AssertionError(f"potential edge case: rel {rel}")
        worst = max(worst, rel)
    return worst


def check_catalog(np, res, n: int, minsize: int, by_size: bool = True
                  ) -> None:
    """Finite energies; ids 1..ngroups, each at least minsize, numbered by
    decreasing size (``by_size``: substructure ids follow the field
    structures, and a host shrinks when its substructure is carved out);
    properties of ngroups + 1 rows, the bulk ones finite."""
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
    if (s < minsize).any() or (by_size and (s[1:] > s[:-1]).any()):
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


def fof_peak_gib(torch, opt, pos, vel, mass, dev) -> float:
    """Peak device memory, in GiB, of one ``search_full_set`` (the "fof"
    stage of find_structures) with its inputs already on the card and
    counted."""
    from velociraptor_stf_tpu_torch.models import halos

    tpos, tvel, tmass = (torch.from_numpy(a).to(dev)
                         for a in (pos, vel, mass))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    halos.search_full_set(opt, tpos, tvel, tmass, BOXSIZE)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


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


def check_cli_files(np, out: str, ng: int, npart: int,
                    nedges: Optional[int], hierarchy: bool = True,
                    sizes_want=None) -> None:
    """Parse the binary .properties, .catalog_groups, .catalog_particles,
    .hierarchy (unless not ``hierarchy``) and .profiles (unless
    ``nedges`` is None) of ``out`` and hold them to ``ng`` groups, each
    of at least one member or of ``sizes_want`` members."""
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
    small = (sizes < 1).any() if sizes_want is None else \
        not np.array_equal(sizes, sizes_want)
    if small or not np.array_equal(
            offs, np.concatenate([[0], np.cumsum(sizes)[:-1]])):
        raise AssertionError(".catalog_groups: sizes and offsets disagree")
    (npid, _), rest = _binary(np, Path(out + ".catalog_particles"), 2)
    pids = np.frombuffer(rest, np.int64)
    if npid != sizes.sum() or len(pids) != npid or pids.min() < 1 or \
            pids.max() > npart or len(np.unique(pids)) != npid:
        raise AssertionError(".catalog_particles: bad particle ids")
    if hierarchy:
        (c, _), rest = _binary(np, Path(out + ".hierarchy"), 2)
        if c != ng or len(rest) != 16 * ng:
            raise AssertionError(f".hierarchy: {c} groups")
    if nedges is None:
        return
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
    from velociraptor_stf_tpu_torch import cli
    from velociraptor_stf_tpu_torch.io import gadget
    from velociraptor_stf_tpu_torch.io.synthetic import make_cosmo_mock
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
        api_s = api_case(torch, np, dev, cfg, out, res, spos, svel, smass,
                         pids, box)
        return (f"{res.ngroups} groups in every file, CLI {wall:.1f} s "
                f"wall ({timeline[-1] if timeline else 'no TIME line'}); "
                f"library API on device tensors: the same group ids and "
                f".catalog_groups bytes, invoke {api_s:.3f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def api_case(torch, np, dev, cfg: Path, out: str, res, pos, vel, mass, pids,
             box: float) -> float:
    """The library API on the CLI phase's particles, handed over as
    tensors already on the card: ``invoke`` must give find_structures'
    group ids and, with ``write_output``, the ``.catalog_groups`` bytes the
    CLI wrote.  Returns invoke's wall seconds."""
    from velociraptor_stf_tpu_torch import api
    from velociraptor_stf_tpu_torch.utils import units

    session = api.VelociraptorSession(config=str(cfg))
    tpos, tvel, tmass = (torch.from_numpy(np.ascontiguousarray(
        a, np.float32)).to(dev) for a in (pos, vel, mass))
    tpids = torch.from_numpy(np.ascontiguousarray(pids, np.int64)).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = session.invoke(
        tpos, tvel, tmass, pids=tpids,
        cosmo=api.CosmoInfo(atime=1.0, littleh=1.0, Omega_m=0.3,
                            Omega_Lambda=0.7),
        sim=api.SimInfo(period=box, interparticlespacing=units.
                        interparticle_spacing(box, len(pids))),
        outname=out + ".api", write_output=True, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if got["ngroups"] != res.ngroups or \
            not np.array_equal(got["group_id"], res.pfof):
        raise AssertionError(
            f"library API: {got['ngroups']} groups against "
            f"{res.ngroups}, "
            f"{int((got['group_id'] != res.pfof).sum())} ids differ")
    if Path(out + ".api.catalog_groups").read_bytes() != \
            Path(out + ".catalog_groups").read_bytes():
        raise AssertionError("library API: .catalog_groups differs from "
                             "the CLI's")
    return wall


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


HYDRO_OVERRIDES = """
Baryon_searchflag=1
Particle_search_type=1
"""
HYDRO_SAMPLE = 16384        # baryons held to the brute-force association
HYDRO_CPU_N = 1 << 18       # size of the plain-version comparison


def hydro_inputs(np, n: int):
    """Particle types and hydro fields of n particles: every 6th a baryon
    (bench.py:83-89), the baryons split evenly into gas and stars, and the
    internal energy, star formation rate (zero for half the gas),
    metallicity and stellar age drawn from one seed."""
    rng = np.random.default_rng(7)
    baryon = np.arange(n) % 6 == 5
    ptype = np.where(baryon, np.where(rng.random(n) < 0.5, 0, 4),
                     1).astype(np.int8)
    extras = {
        "u": rng.uniform(10.0, 100.0, n),
        "sfr": np.where(rng.random(n) < 0.5, rng.uniform(0.1, 2.0, n), 0.0),
        "zmet": rng.uniform(0.0, 0.03, n),
        "tage": rng.uniform(0.0, 10.0, n)}
    return ptype, {k: v.astype(np.float32) for k, v in extras.items()}


def hydro_options(n: int, C, cfg_path: Path):
    """The slice's options with the baryon search on (the bench's
    VR_BENCH_BARYONS=1 variant)."""
    cfg_path.write_text(SLICE_CFG.read_text() + SLICE_OVERRIDES +
                        HYDRO_OVERRIDES)
    return slice_options(n, C, BOXSIZE, cfg_path)


def check_association(torch, np, dev, opt, pos, vel, mass, ptype) -> str:
    """The association alone against float64 numpy on the host: the DM
    search and field unbind, ``search_baryons`` on the card, and for
    HYDRO_SAMPLE baryons the brute-force answer -- among the tagged DM
    within the linking length (scipy's periodic cKDTree), the lowest
    dx^2/ellx^2 + dv^2/ellv^2 <= 1, equal distances to the lowest group
    id.  A disagreement counts only where float64 separates the
    candidates by more than 1e-5 (the card measures in float32)."""
    from scipy.spatial import cKDTree

    from velociraptor_stf_tpu_torch.models import baryons
    from velociraptor_stf_tpu_torch.models.pipeline import search_and_unbind

    dm = ptype == 1
    sres = search_and_unbind(opt, pos[dm], vel[dm], mass[dm],
                             boxsize=BOXSIZE, device=dev)
    tvel_dm = torch.from_numpy(vel[dm]).to(dev)
    vscale2 = baryons.velocity_scale2(tvel_dm, sres.pfof)
    grp = baryons.search_baryons(
        opt, torch.from_numpy(pos[dm]).to(dev), tvel_dm, sres.pfof,
        torch.from_numpy(pos[~dm]).to(dev),
        torch.from_numpy(vel[~dm]).to(dev), boxsize=BOXSIZE,
        vscale2=vscale2).cpu().numpy()
    pfof_dm = sres.pfof.cpu().numpy()
    tag = pfof_dm > 0
    pd, vd, gd = (pos[dm][tag].astype(np.float64),
                  vel[dm][tag].astype(np.float64), pfof_dm[tag])
    ellx = opt.ellphys * opt.ellxscale * opt.ellhalophysfac
    ellv2 = max(vscale2, 1e-30) * opt.ellhalovelfac ** 2
    # float32 positions can equal the box size: wrap them for the tree
    tree = cKDTree(np.mod(pd, BOXSIZE), boxsize=BOXSIZE)
    nb = int((~dm).sum())
    sample = np.random.default_rng(3).choice(nb, min(HYDRO_SAMPLE, nb),
                                             replace=False)
    # half of the sample from the baryons that got a group
    assigned = np.nonzero(grp > 0)[0]
    sample[:len(sample) // 2] = np.random.default_rng(4).choice(
        assigned, len(sample) // 2, replace=len(assigned) < len(sample))
    pb = pos[~dm][sample].astype(np.float64)
    vb = vel[~dm][sample].astype(np.float64)
    near = tree.query_ball_point(np.mod(pb, BOXSIZE), ellx * (1 + 1e-6))
    wrong = close = 0
    for i, cand in enumerate(near):
        got = int(grp[sample[i]])
        if not cand:
            wrong += got != 0
            continue
        cand = np.asarray(cand)
        d = pb[i] - pd[cand]
        d -= BOXSIZE * np.round(d / BOXSIZE)
        dist = (d * d).sum(1) / (ellx * ellx) + \
            ((vb[i] - vd[cand]) ** 2).sum(1) / ellv2
        inside = dist <= 1.0
        dmin = dist[inside].min() if inside.any() else np.inf
        want = int(gd[cand][inside & (dist == dmin)].min()) \
            if inside.any() else 0
        if got == want:
            continue
        # float32 may order two candidates within 1e-5 the other way, or
        # place one on the other side of the ellipse's edge
        mine = dist[gd[cand] == got].min(initial=np.inf) if got else np.inf
        edge = abs(min(dmin, mine) - 1.0) <= 1e-5 if got == 0 or want == 0 \
            else False
        if edge or (got and want and mine <= dmin * (1 + 1e-5)):
            close += 1
        else:
            wrong += 1
    if wrong:
        raise AssertionError(f"association: {wrong} of {len(sample)} sampled "
                             "baryons are not with their phase-nearest "
                             "tagged DM particle")
    return (f"{len(sample)} sampled baryons ({int((grp[sample] > 0).sum())} "
            f"with a group) equal the float64 brute force ({close} within "
            f"1e-5 of a tie or of the ellipse's edge); {int(tag.sum())} "
            f"tagged DM, ellx {ellx:.5f}, ellv2 {ellv2:.6g}")


def unbound_members(np, frame, mass, vel, W, eratio: float):
    """Members of each frame id > 0 that are not bound in the frame of
    that set's mass-weighted mean velocity: Eratio * T + W > 1e-4 |W|
    (the ejection loop carries its sums in float32)."""
    m64, v64 = mass.astype(np.float64), vel.astype(np.float64)
    nf = int(frame.max()) + 1
    gm = np.bincount(frame, weights=m64, minlength=nf)
    vcm = np.stack([np.bincount(frame, weights=m64 * v64[:, k],
                                minlength=nf) for k in range(3)], 1)
    vcm /= np.maximum(gm, 1e-30)[:, None]
    T = 0.5 * m64 * ((v64 - vcm[frame]) ** 2).sum(1)
    W64 = W.astype(np.float64)
    return (frame > 0) & (eratio * T + W64 > 1e-4 * np.abs(W64))


def check_hydro_catalog(np, res, mass, vel, ptype, eratio: float) -> str:
    """The hydro catalog against float64 numpy on the returned arrays:
    per group n_gas + n_star + n_bh + its DM count == num; M_gas_sf +
    M_gas_nsf == M_gas (rel 1e-5); every particle with a group id, the
    baryons among them, is bound in its group's frame, the
    mass-weighted mean velocity of the members: Eratio * T + W < 0 (to
    1e-4 |W|: the ejection loop carries its sums in float32)."""
    ng = res.ngroups
    pr = res.props
    pfof = res.pfof.astype(np.int64)
    ndm = np.bincount(pfof[ptype == 1], minlength=ng + 1)
    total = pr["n_gas"] + pr["n_star"] + pr["n_bh"] + ndm
    if not np.array_equal(total[1:], pr["num"][1:]) or \
            not np.array_equal(pr["num"][1:], np.bincount(
                pfof, minlength=ng + 1)[1:]):
        raise AssertionError("hydro catalog: per-type counts do not add up "
                             "to the group sizes")
    for t, code in (("gas", 0), ("star", 4)):
        if not np.array_equal(pr[f"n_{t}"][1:], np.bincount(
                pfof[ptype == code], minlength=ng + 1)[1:]):
            raise AssertionError(f"hydro catalog: n_{t} differs from numpy")
    split = pr["M_gas_sf"] + pr["M_gas_nsf"]
    rel = np.abs(split - pr["M_gas"])[1:] / np.maximum(pr["M_gas"][1:], 1e-30)
    if rel.max() > 1e-5:
        raise AssertionError(f"hydro catalog: M_gas_sf + M_gas_nsf differs "
                             f"from M_gas by rel {rel.max()}")
    for k in ("M_gas", "M_star", "cm_gas", "sigV_star", "R_HalfMass_gas",
              "Temp_mean_gas", "SFR_gas", "Zmet_star", "t_mean_star",
              "q_gas", "Krot_star", "M_200crit_gas"):
        if not np.isfinite(pr[k]).all():
            raise AssertionError(f"hydro catalog: {k} not finite")
    ing = pfof > 0
    loose = unbound_members(np, pfof, mass, vel, res.W, eratio)
    if loose.any():
        raise AssertionError(
            f"hydro catalog: {int(loose.sum())} grouped particles "
            f"({int((loose & (ptype != 1)).sum())} baryons) are unbound "
            "after the combined unbind")
    nb_in = int((ing & (ptype != 1)).sum())
    return (f"{ng} groups: type counts add up, M_gas_sf + M_gas_nsf = M_gas "
            f"(rel {rel.max():.2g}), all {int(ing.sum())} grouped particles "
            f"({nb_in} baryons) bound; gas fraction of the members "
            f"{pr['n_gas'][1:].sum() / max(pr['num'][1:].sum(), 1):.4f}")


def hydro_case(torch, np, dev, C, kernels, pos, vel, mass, n: int):
    """Phase 8: the hydro path at full width.  Returns the kernels' launch
    counts over the second run."""
    from velociraptor_stf_tpu_torch.io.synthetic import make_cosmo_mock
    from velociraptor_stf_tpu_torch.models.pipeline import find_structures
    from velociraptor_stf_tpu_torch.utils import telemetry

    tmp = Path(tempfile.mkdtemp(prefix="vr_hydro_"))
    try:
        opt = hydro_options(n, C, tmp / "hydro.cfg")
        ptype, extras = hydro_inputs(np, len(pos))
        nbar = int((ptype != 1).sum())
        log(f"phase 8 input: {len(pos) - nbar} DM, {int((ptype == 0).sum())}"
            f" gas, {int((ptype == 4).sum())} stars")
        first = None
        for rep in range(2):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            telemetry.reset()
            t0 = time.perf_counter()
            res = find_structures(opt, pos, vel, mass, boxsize=BOXSIZE,
                                  ptype=ptype, extras=extras, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(kernels.LAUNCHES)
            check_catalog(np, res, len(pos), opt.MinSize)
            if first is None:
                first = res
            elif not same_catalog(np, res, first):
                raise AssertionError("hydro path: two runs on the same "
                                     "input differ")
            share = float((res.pfof[ptype != 1] > 0).mean())
            digest = hashlib.sha256(res.pfof.tobytes() + res.W.tobytes())
            log(f"phase 8 run {rep} ({'warm-up' if rep == 0 else 'timed'}): "
                f"ngroups {res.ngroups} timings {json.dumps(res.timings)} "
                f"wall {wall:.3f} s; {share:.4f} of the baryons assigned; "
                f"{telemetry.snapshot().get('baryon_pairs', 0)} pairs "
                f"enumerated; ids and potentials sha256 "
                f"{digest.hexdigest()[:16]}")
        log(f"phase 8 launches {json.dumps(counts)} peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; two runs "
            f"equal bit for bit ({len(res.props)} property arrays)")
        missing = [k for k, v in counts.items() if v <= 0]
        if missing or counts["potential"] < 2:
            raise AssertionError(f"hydro path: kernels not launched "
                                 f"{missing}, potential launched "
                                 f"{counts['potential']} times (field and "
                                 "combined unbind need 2)")
        if {"fof", "unbind", "baryons", "properties", "so"} - \
                set(res.timings):
            raise AssertionError(f"hydro path: stages {sorted(res.timings)}")
        log("phase 8 catalog: " + check_hydro_catalog(
            np, res, mass, vel, ptype, opt.uinfo.Eratio))
        del res, first
        log("phase 8 association: " + check_association(
            torch, np, dev, opt, pos, vel, mass, ptype))

        # the same kind of input at a reduced size through the plain
        # versions on the CPU: the expected group ids of the kernels' run
        cn = HYDRO_CPU_N
        cpos, cvel, cmass = make_cosmo_mock(cn, boxsize=BOXSIZE,
                                            nhalos=max(64, cn // 16384),
                                            seed=7)
        cptype, cextras = hydro_inputs(np, len(cpos))
        copt = hydro_options(cn, C, tmp / "hydro_small.cfg")
        t0 = time.perf_counter()
        want = find_structures(copt, cpos, cvel, cmass, boxsize=BOXSIZE,
                               ptype=cptype, extras=cextras, device="cpu")
        cpu_s = time.perf_counter() - t0
        got = find_structures(copt, cpos, cvel, cmass, boxsize=BOXSIZE,
                              ptype=cptype, extras=cextras, device=dev)
        if got.ngroups != want.ngroups or \
                not np.array_equal(got.pfof, want.pfof):
            raise AssertionError(
                f"hydro path at n={cn}: the kernels give {got.ngroups} "
                f"groups, the plain versions {want.ngroups}; "
                f"{int((got.pfof != want.pfof).sum())} ids differ")
        log(f"phase 8 plain versions at n={cn}: {want.ngroups} groups, "
            f"{int((want.pfof[cptype != 1] > 0).sum())} baryons in groups, "
            f"group ids equal to the kernels' run (plain run {cpu_s:.1f} s "
            "on the host)")
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sub_options(n: int, C, cfg_path: Path):
    """Phase 9's options: the slice's, with the substructure search."""
    cfg_path.write_text(SLICE_CFG.read_text() + SLICE_OVERRIDES +
                        SUB_OVERRIDES)
    return slice_options(n, C, BOXSIZE, cfg_path)


def check_hierarchy(np, res, maxlevel: int, orphans: bool = False) -> int:
    """Parents in range and never the group itself, level = parent's
    level + 1 (0 for field structures), hostid the top ancestor (-1 for
    field structures), no cycle.  ``orphans``: a substructure whose parent
    the combined unbind of a baryon search dissolved keeps its level with
    parent 0, and its hostid is 0 where that unbind dissolved its host
    too, else the host, a field structure; its own substructures share
    its hostid (``models/pipeline.py::_remap_hierarchy``, as in the JAX
    package).  Returns the deepest level."""
    ng = res.ngroups
    parent, host, level = (np.asarray(a, np.int64) for a in (
        res.parent, res.hostid, res.hierarchy_level))
    if not (len(parent) == len(host) == len(level) == ng + 1):
        raise AssertionError("hierarchy: arrays of the wrong length")
    g = np.arange(1, ng + 1)
    p = parent[1:]
    if ((p < 0) | (p > ng) | (p == g)).any():
        raise AssertionError("hierarchy: parent out of range or itself")
    orphan = np.zeros(ng + 1, bool)
    if orphans:
        orphan[1:] = (p == 0) & (level[1:] > 0)
    want_level = np.where(p > 0, level[np.maximum(p, 0)] + 1, 0)
    if not np.array_equal(level[1:][~orphan[1:]], want_level[~orphan[1:]]):
        raise AssertionError("hierarchy: level != parent's level + 1")
    top = g.copy()
    for _ in range(maxlevel + 2):
        nxt = parent[top]
        top = np.where(nxt > 0, nxt, top)
    if (parent[top] > 0).any():
        raise AssertionError("hierarchy: a cycle (no top after "
                             f"{maxlevel + 2} steps)")
    oh = host[orphan]
    if ((oh != 0) & ((oh < 0) | (oh > ng) | (parent[np.clip(oh, 0, ng)] > 0)
                     | (level[np.clip(oh, 0, ng)] > 0))).any():
        raise AssertionError("hierarchy: an orphan's host is no field "
                             "structure")
    want_host = np.where(orphan[top], host[top], np.where(top == g, -1, top))
    if not np.array_equal(host[1:], want_host):
        raise AssertionError("hierarchy: hostid is not the top ancestor")
    return int(level.max())


def check_bound_tops(np, res, mass, vel, eratio: float) -> int:
    """Every member of a top-level structure (a field halo with its
    substructures' members, the set the field unbind left) is bound in
    the frame of that set's mean velocity: Eratio * T + W < 0, to 1e-4
    |W| (the ejection loop carries its sums in float32).  Returns the
    members checked."""
    g = res.pfof.astype(np.int64)
    host = np.asarray(res.hostid, np.int64)
    top = np.where(g > 0, np.where(host[g] > 0, host[g], g), 0)
    loose = unbound_members(np, top, mass, vel, res.W, eratio)
    if loose.any():
        raise AssertionError(f"substructure path: {int(loose.sum())} "
                             "members of top-level structures unbound")
    return int((top > 0).sum())


def planted_options(C, G):
    """The planted check's options: FOF3D field halos (one per planted
    host), tests/test_substructure.py's substructure options, unbinding
    on (as tests/test_torch_subcatalog.py::planted_options)."""
    opt = C.Options()
    opt.ellphys, opt.ellxscale, opt.ellhalophysfac = 0.2, 0.25, 4.0
    opt.fofbgtype = C.FOF3D
    opt.MinSize = opt.HaloMinSize = 20
    opt.iSubSearch, opt.iiterflag = 1, 1
    opt.ellthreshold, opt.Vratio, opt.thetaopen, opt.ellfac = \
        2.5, 2.0, 0.10, 1.0
    opt.uinfo.unbindflag, opt.uinfo.Eratio, opt.iBoundHalos = 1, 1.0, 1
    opt.G = G
    C.config_check(opt)
    return opt


def batch_against_per_structure(torch, S, checked: list):
    """Wrap ``S.search_subset_batch`` so that every structure of a call is
    searched again alone, as a batch of one (a copy of its entry): ids
    and group counts must be equal, whatever the structures it was
    batched with.  Appends (structures, group ids compared) per call to
    ``checked``; returns the function that unwraps."""
    real = S.search_subset_batch

    def checking(opt, entries, pair_budget=None):
        real(opt, entries, pair_budget)
        ids = 0
        for e in entries:
            k = e["nsub"]
            alone = dict(e)
            real(opt, [alone], pair_budget)
            if alone["ng_sub"] != e["ng_sub"] or \
                    not torch.equal(alone["sub"], e["sub"]):
                raise AssertionError(
                    f"subset search: a structure of {k} rows has "
                    f"{e['ng_sub']} groups in a batch of {len(entries)}, "
                    f"{alone['ng_sub']} alone; "
                    f"{int((alone['sub'] != e['sub']).sum())} ids differ")
            ids += k
        checked.append((len(entries), ids))

    S.search_subset_batch = checking

    def undo():
        S.search_subset_batch = real
    return undo


def cores_against_per_structure(torch, S, checked: list):
    """Wrap ``S.search_cores_batch`` so that every structure of a call is
    searched again alone, as a batch of one (a copy of its entry): core
    ids and core counts must be equal.  Appends (structures, rows,
    differing ids) per call to ``checked``; returns the function that
    unwraps."""
    real = S.search_cores_batch

    def checking(opt, entries, level, pair_budget=None):
        got = real(opt, entries, level, pair_budget)
        rows = differ = 0
        for e, (core, nc) in zip(entries, got):
            k = e["nsub"]
            (want, nc_want), = real(opt, [dict(e)], level, pair_budget)
            bad = int((want != core).sum())
            if nc != nc_want or bad:
                raise AssertionError(
                    f"core search: a structure of {k} rows has {nc} cores "
                    f"in a batch of {len(entries)}, {nc_want} alone; "
                    f"{bad} ids differ")
            rows += k
            differ += bad
        checked.append((len(entries), rows, differ))
        return got

    S.search_cores_batch = checking

    def undo():
        S.search_cores_batch = real
    return undo


def subsub_case(torch, np, dev, C, kernels, pos, vel, mass, n: int):
    """Phase 9: the substructure path at full width.  Returns the
    kernels' launch counts over the last run."""
    from velociraptor_stf_tpu_torch.io.synthetic import (G_KMS,
                                                         planted_subhalos)
    from velociraptor_stf_tpu_torch.models import substructure
    from velociraptor_stf_tpu_torch.models.pipeline import find_structures
    from velociraptor_stf_tpu_torch.utils import telemetry

    tmp = Path(tempfile.mkdtemp(prefix="vr_sub_"))
    try:
        opt = sub_options(n, C, tmp / "sub.cfg")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    first = None
    checked: list = []
    cores_checked: list = []
    for rep in range(2):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        telemetry.reset()
        # the warm-up run holds each structure's batched searches to its
        # searches alone
        undo = [batch_against_per_structure(torch, substructure, checked),
                cores_against_per_structure(torch, substructure,
                                            cores_checked)] \
            if rep == 0 else []
        t0 = time.perf_counter()
        try:
            res = find_structures(opt, pos, vel, mass, boxsize=BOXSIZE,
                                  device=dev)
        finally:
            for u in undo:
                u()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
        tele = telemetry.snapshot()
        digest = hashlib.sha256(res.pfof.tobytes() + res.W.tobytes() +
                                res.parent.tobytes())
        log(f"phase 9 run {rep} ({'warm-up' if rep == 0 else 'timed'}): "
            f"ngroups {res.ngroups} timings {json.dumps(res.timings)} "
            f"wall {wall:.3f} s; ids, potentials and parents sha256 "
            f"{digest.hexdigest()[:16]}")
        check_catalog(np, res, len(pos), opt.MinSize, by_size=False)
        deepest = check_hierarchy(np, res, C.MAXSUBLEVEL)
        if first is None:
            first = res
        elif not (same_catalog(np, res, first) and all(
                np.array_equal(getattr(res, k), getattr(first, k))
                for k in ("hostid", "parent", "hierarchy_level"))):
            raise AssertionError("substructure path: two runs on the same "
                                 "input differ")
    unbinds = 1
    for lv in range(1, C.MAXSUBLEVEL + 1):
        searched = tele.get(f"subsub_level{lv}_structures")
        if searched is None:
            break
        cand = tele.get(f"subsub_level{lv}_candidates", 0)
        found = tele.get(f"subsub_level{lv}_found", 0)
        unbinds += cand > 0
        log(f"phase 9 level {lv}: {searched} structures searched, {cand} "
            f"candidates, {found} substructures found" +
            ("" if found else " (no substructure at this level)"))
    searched = sum(v for k, v in tele.items()
                   if k.startswith("subsub_level") and
                   k.endswith("_structures"))
    with_cores = sum(v for k, v in tele.items()
                     if k.startswith("subsub_level") and
                     k.endswith("_structures") and
                     int(k[len("subsub_level"):-len("_structures")]) <=
                     opt.maxnlevelcoresearch) \
        if opt.iHaloCoreSearch > 0 else 0
    log(f"phase 9 subset search: {searched} structures in "
        f"{tele.get('subset_batches', 0)} batches, "
        f"{tele.get('subset_batch_candidates', 0)} candidate slots, "
        f"{tele.get('subset_batch_pairs', 0)} pairs tested; laps subset "
        f"{res.timings.get('subsub_subset', 0.0):.4f} s, cores "
        f"{res.timings.get('subsub_cores', 0.0):.4f} s; warm-up run: "
        f"{sum(c[0] for c in checked)} structures "
        f"({sum(c[1] for c in checked)} rows) in {len(checked)} batched "
        "calls equal to their searches alone")
    if not checked or sum(c[0] for c in checked) != searched or \
            (searched and not tele.get("subset_batches")):
        raise AssertionError(f"substructure path: {searched} structures "
                             "searched, "
                             f"{sum(c[0] for c in checked)} were checked")
    log(f"phase 9 core search: warm-up run: "
        f"{sum(c[0] for c in cores_checked)} of {with_cores} structures "
        f"({sum(c[1] for c in cores_checked)} rows) in "
        f"{len(cores_checked)} batched calls equal to their searches alone")
    if sum(c[0] for c in cores_checked) != with_cores:
        raise AssertionError("substructure path: the batched core search "
                             "was not checked on every structure")
    nsub = int((res.parent[1:] > 0).sum())
    log(f"phase 9 hierarchy: {res.ngroups - nsub} field structures, {nsub} "
        f"substructures, deepest level {deepest}; "
        f"{tele.get('subsub_cores_promoted', 0)} merger cores promoted")
    log(f"phase 9 launches {json.dumps(counts)} peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"two runs equal bit for bit ({len(res.props)} property arrays)")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing or counts["potential"] < unbinds:
        raise AssertionError(f"substructure path: kernels not launched "
                             f"{missing}, potential launched "
                             f"{counts['potential']} times (the field "
                             f"unbind and the level unbinds need {unbinds})")
    if {"fof", "unbind", "substructure", "properties", "so"} - \
            set(res.timings):
        raise AssertionError(f"substructure path: stages "
                             f"{sorted(res.timings)}")
    nb = check_bound_tops(np, res, mass, vel, opt.uinfo.Eratio)
    log(f"phase 9 boundness: all {nb} members of top-level structures "
        "bound")
    del res, first

    # three planted hosts with subhalos: the card against the CPU
    ppos, pvel, pmass, host = planted_subhalos(3, seed=3, offset=4.0)
    popt = planted_options(C, G_KMS)
    got = find_structures(popt, ppos, pvel, pmass, boxsize=16.0,
                          device=dev)
    want = find_structures(planted_options(C, G_KMS), ppos, pvel, pmass,
                           boxsize=16.0, device="cpu")
    same = got.ngroups == want.ngroups and \
        np.array_equal(got.pfof, want.pfof) and all(
            np.array_equal(getattr(got, k), getattr(want, k))
            for k in ("parent", "hostid", "hierarchy_level"))
    nfound = int((want.parent[1:] > 0).sum())
    if not same or nfound < 2:
        raise AssertionError(
            f"planted subhalos: card {got.ngroups} groups, host "
            f"{want.ngroups}; {int((got.pfof != want.pfof).sum())} ids "
            f"differ; {nfound} substructures found (need 2)")
    log(f"phase 9 planted subhalos: {want.ngroups} groups, {nfound} "
        "substructures, ids, parent, hostid and level equal on the card "
        "and on the CPU")
    return counts


MESH_SHARDS = 4             # phase 10's shards on one card
MESH_SMALL_N = 128 ** 3     # phase 10's hydro and substructure paths
DENSITY_N = 1 << 20         # phase 10's density comparison
SO_RTOL = 1e-6              # the JAX package's mesh gate on SO masses


def mesh_differences(np, got, want, pos, vel, mass, opt, limit: int = 20
                     ) -> str:
    """Each particle whose group differs between two catalogs (at most
    ``limit``), with its margins: the bound criterion's Eratio * T + W
    relative to |W| in its one-device group's frame, and its nearest 6D
    distance to 1 among the members of its 3DFOF group
    (d2 / ell6^2 + dv2 / vscale2, the 3DFOF group's dispersion)."""
    idx = np.nonzero(got.pfof != want.pfof)[0]
    b6 = opt.ellphys * opt.ellxscale * opt.ellhalophysfac * \
        opt.ellhalo6dxfac
    lines = [f"{len(idx)} particles in another group"]
    for i in idx[:limit]:
        g = int(want.pfof[i]) or int(got.pfof[i])
        dv = vel[i] - want.props["gcmvel"][g] if int(want.pfof[i]) else \
            vel[i] - got.props["gcmvel"][g]
        W = float(want.W[i])
        E = opt.uinfo.Eratio * 0.5 * float(mass[i]) * float(dv @ dv) + W
        p3 = want.pfof3d if want.pfof3d is not None else want.pfof
        same3 = np.nonzero(p3 == p3[i])[0]
        same3 = same3[same3 != i]
        d = pos[same3] - pos[i]
        d -= BOXSIZE * np.round(d / BOXSIZE)
        w = mass[same3] / mass[same3].sum()
        vm = (vel[same3] * w[:, None]).sum(0)
        s2 = float((w * ((vel[same3] - vm) ** 2).sum(1)).sum()) * \
            opt.ellhalo6dvfac ** 2
        ph = (d ** 2).sum(1) / b6 ** 2 + \
            ((vel[same3] - vel[i]) ** 2).sum(1) / max(s2, 1e-30)
        lines.append(f"particle {i}: group {int(got.pfof[i])} (mesh) vs "
                     f"{int(want.pfof[i])}; (E)/|W| {E / abs(W):.3e}; "
                     f"nearest 6D distance - 1 {ph.min() - 1:.3e}")
    return "; ".join(lines)


def check_mesh_catalog(np, got, want, pos, vel, mass, opt, what: str) -> str:
    """Phase 10's gates against the one-device catalog: the 3DFOF
    partition, the group count, ids (hence the bound masks) and hierarchy
    equal, the SO keys within SO_RTOL; the potentials' differing count is
    reported."""
    if got.ngroups != want.ngroups or \
            not np.array_equal(got.pfof, want.pfof):
        raise AssertionError(f"{what}: groups {got.ngroups} vs "
                             f"{want.ngroups}; " + mesh_differences(
                                 np, got, want, pos, vel, mass, opt))
    for k in ("pfof3d", "hostid", "parent", "hierarchy_level", "stype"):
        a, b = getattr(got, k), getattr(want, k)
        if (a is None) != (b is None) or \
                (b is not None and not np.array_equal(a, b)):
            raise AssertionError(f"{what}: {k} differs")
    worst = 0.0
    for k in ("gmass", "gM200c", "gR200c", "gMvir"):
        a = want.props[k][1:].astype(np.float64)
        b = got.props[k][1:].astype(np.float64)
        with np.errstate(invalid="ignore"):
            rel = np.where(a == b, 0.0,
                           np.abs(b - a) / np.maximum(np.abs(a), 1e-300))
        worst = max(worst, float(rel.max(initial=0.0)))
        if not np.allclose(b, a, rtol=SO_RTOL, atol=0):
            g = int(np.argmax(rel)) + 1
            raise AssertionError(
                f"{what}: {k} beyond rtol {SO_RTOL} in "
                f"{int((rel > SO_RTOL).sum())} groups, worst rel "
                f"{rel.max():.3g} at group {g} ({int(want.props['num'][g])}"
                f" members, gsize {float(want.props['gsize'][g]):.4g}, "
                f"R200c {float(want.props['gR200c'][g]):.4g})")
    nw = int((got.W != want.W).sum()) if want.W is not None else 0
    same = sum(np.array_equal(got.props[k], want.props[k], equal_nan=True)
               for k in want.props)
    return (f"{got.ngroups} groups, ids, 3DFOF ids and hierarchy equal; "
            f"SO keys worst rel {worst:.3g}; {nw} potentials differ; "
            f"{same} of {len(want.props)} property arrays bit-equal")


def mesh_counters(np, tele: dict, n: int) -> str:
    """The collectives by stage and kind, checked as
    tests/test_torch_collective_audit.py checks them."""
    parts = []
    for k in sorted(k for k in tele if k.startswith("coll_bytes::")):
        key = k[len("coll_bytes::"):]
        ops = tele["coll_ops::" + key]
        if key.endswith("::reshard"):
            if tele[k] >= 24 * 4 * n:
                raise AssertionError(f"mesh deal {key}: {tele[k]} bytes")
        elif tele[k] / max(ops, 1) >= 4 * n:
            raise AssertionError(f"mesh collective {key}: "
                                 f"{tele[k] / ops:.0f} bytes a call")
        parts.append(f"{key} {ops} ops {tele[k]} B")
    return "; ".join(parts)


def mesh_case(torch, np, dev, C, kernels, pos, vel, mass, n: int, want,
              report) -> None:
    """Phase 10: the mesh path on the card (MESH_SHARDS shards on one
    card, and a mesh over every card when there are several)."""
    from velociraptor_stf_tpu_torch.io.synthetic import (G_KMS,
                                                         make_cosmo_mock,
                                                         planted_subhalos)
    from velociraptor_stf_tpu_torch.models import localfield
    from velociraptor_stf_tpu_torch.models.pipeline import find_structures
    from velociraptor_stf_tpu_torch.parallel import distributed_localfield
    from velociraptor_stf_tpu_torch.parallel.mesh import Mesh, make_mesh
    from velociraptor_stf_tpu_torch.utils import telemetry

    from velociraptor_stf_tpu_torch.ops import segments

    # why the shards' group sums equal one device's: a segment reduced
    # from an aligned start (ops/segments.py) is a function of its own
    # values, wherever it lies; torch.segment_reduce on a card is not
    v = torch.rand(100_000, generator=torch.Generator().manual_seed(0),
                   dtype=torch.float32).to(dev)
    raw, aligned = set(), set()
    for pad in range(8):
        vp = torch.cat([torch.zeros(pad, device=dev), v])
        ids = (torch.arange(vp.shape[0], device=dev) >= pad).long()
        raw.add(float(torch.segment_reduce(
            vp, "sum", lengths=torch.bincount(ids, minlength=2),
            unsafe=True)[1]))
        aligned.add(float(segments.segment_sum(vp, ids, 2,
                                               presorted=True)[1]))
    log(f"phase 10 one 100,000-value segment at 8 offsets: "
        f"torch.segment_reduce gives {len(raw)} float32 sums, "
        f"ops/segments.py::segment_sum {len(aligned)}")
    if len(aligned) != 1:
        raise AssertionError("segment sums depend on the segment's offset")

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    card0 = torch.device(dev.type, 0) if dev.type == "cuda" else dev
    meshes = [(f"{MESH_SHARDS} shards on {card0}",
               Mesh((card0,) * MESH_SHARDS))]
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        meshes.append((f"{torch.cuda.device_count()} cards", make_mesh()))
    else:
        log("phase 10: the mesh over several cards was not run: "
            f"{torch.cuda.device_count()} card(s) visible")
    tmp = Path(tempfile.mkdtemp(prefix="vr_mesh_"))
    try:
        opt = slice_options(n, C, BOXSIZE, write_slice_config(
            tmp / "slice.cfg"))
        for label, mesh in meshes:
            first = None
            for rep in range(2):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launches()
                telemetry.reset()
                t0 = time.perf_counter()
                res = find_structures(opt, pos, vel, mass, boxsize=BOXSIZE,
                                      mesh=mesh)
                sync()
                wall = time.perf_counter() - t0
                counts = dict(kernels.LAUNCHES)
                tele = telemetry.snapshot()
                check_catalog(np, res, len(pos), opt.HaloMinSize or
                              opt.MinSize)
                if first is None:
                    first = res
                elif not same_catalog(np, res, first):
                    raise AssertionError(f"mesh ({label}): two runs on the "
                                         "same input differ")
                st = {k: round(res.timings[k], 4) for k in
                      ("fof", "unbind", "properties", "so")}
                log(f"phase 10 {label} run {rep} "
                    f"({'warm-up' if rep == 0 else 'timed'}): ngroups "
                    f"{res.ngroups} stages {json.dumps(st)} wall "
                    f"{wall:.3f} s")
            log(f"phase 10 {label} against phase 4: " + check_mesh_catalog(
                np, res, want, pos, vel, mass, opt, f"mesh ({label})"))
            for stage in ("fof3d", "fof6d"):
                loads = [tele.get(f"mesh_slab_load::slabplan::shard{s}", 0)
                         for s in range(mesh.size)]
                cand = [tele.get(f"mesh_candidates::{stage}::shard{s}", 0)
                        for s in range(mesh.size)]
                log(f"phase 10 {label} {stage}: slab loads {loads}, "
                    f"candidate pairs per shard {cand}, cross-slab rounds "
                    f"{tele.get(stage + '_outer_rounds')}")
            for stage in ("unbind", "props"):
                loads = [tele.get(f"mesh_group_load::{stage}::shard{s}", 0)
                         for s in range(mesh.size)]
                log(f"phase 10 {label} {stage}: particles per shard {loads}")
            log(f"phase 10 {label} collectives: " + mesh_counters(
                np, tele, len(pos)))
            log(f"phase 10 {label} launches {json.dumps(counts)} peak "
                f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                "GiB; two runs equal bit for bit")
            if counts["potential"] <= 0:
                raise AssertionError("mesh path: the potential kernel was "
                                     "not launched")
            if first is not None and label == meshes[0][0]:
                for e in report:
                    e["launches_mesh"] = counts[e["name"]]
            del res, first
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the hydro and substructure paths at 128^3, the planted subhalos and
    # the sharded density: one card's results once, then each mesh's
    sn = MESH_SMALL_N
    spos, svel, smass = make_cosmo_mock(sn, boxsize=BOXSIZE,
                                        nhalos=max(64, sn // 16384), seed=7)
    ptype, extras = hydro_inputs(np, len(spos))
    tmp = Path(tempfile.mkdtemp(prefix="vr_mesh_"))
    try:
        paths = [("hydro", hydro_options(sn, C, tmp / "h.cfg"),
                  dict(ptype=ptype, extras=extras)),
                 ("substructure", sub_options(sn, C, tmp / "s.cfg"), {})]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ones = []
    for what, o, kw in paths:
        t0 = time.perf_counter()
        ones.append(find_structures(o, spos, svel, smass, boxsize=BOXSIZE,
                                    device=dev, **kw))
        sync()
        ones[-1].timings["wall"] = time.perf_counter() - t0
    ppos, pvel, pmass, _ = planted_subhalos(3, seed=3, offset=4.0)
    pone = find_structures(planted_options(C, G_KMS), ppos, pvel, pmass,
                           boxsize=16.0, device=dev)
    nsub = int((pone.parent[1:] > 0).sum())
    if nsub < 2:
        raise AssertionError(f"planted subhalos: {nsub} substructures")
    # the JAX test's density mock (tests/test_distributed.py:300-346),
    # scaled up, its clump across a slab boundary
    rng = np.random.default_rng(77)
    box = 10.0
    nclump = DENSITY_N // 8
    cpos = np.array([box / MESH_SHARDS, 5.0, 5.0]) + \
        rng.normal(0, 0.15, (nclump, 3))
    bpos = rng.random((DENSITY_N - nclump, 3)) * box
    dpos = torch.from_numpy((np.concatenate([cpos, bpos]) % box).astype(
        np.float32)).to(dev)
    dvel = torch.from_numpy(np.concatenate([
        rng.normal(0, 20.0, (nclump, 3)),
        rng.normal(0, 300.0, (DENSITY_N - nclump, 3))]).astype(
            np.float32)).to(dev)
    t0 = time.perf_counter()
    d1 = localfield.velocity_density(dpos, dvel).cpu().numpy()
    t_one = time.perf_counter() - t0

    for label, mesh in meshes:
        for (what, o, kw), one in zip(paths, ones):
            t0 = time.perf_counter()
            got = find_structures(o, spos, svel, smass, boxsize=BOXSIZE,
                                  mesh=mesh, **kw)
            sync()
            dt = time.perf_counter() - t0
            msg = check_mesh_catalog(np, got, one, spos, svel, smass, o,
                                     f"{what} path at n={sn} ({label})")
            if what == "hydro":
                extra = (f"; {int((got.pfof[ptype != 1] > 0).sum())} "
                         "baryons associated, as on one device")
            else:
                extra = (f"; {int((got.parent[1:] > 0).sum())} "
                         "substructures")
            log(f"phase 10 {label} {what} path at n={sn}: {msg}{extra}; one "
                f"device {one.timings['wall']:.3f} s, mesh {dt:.3f} s")
        one = ones[1]
        real = distributed_localfield.DIST_DENSITY_MIN
        distributed_localfield.DIST_DENSITY_MIN = 1
        try:
            t0 = time.perf_counter()
            dres = find_structures(paths[1][1], spos, svel, smass,
                                   boxsize=BOXSIZE, mesh=mesh)
            sync()
            dt = time.perf_counter() - t0
        finally:
            distributed_localfield.DIST_DENSITY_MIN = real
        hosts = [r.pfof * (r.parent[r.pfof] == 0) for r in (one, dres)]
        if not np.array_equal(hosts[0], hosts[1]):
            raise AssertionError("sharded density: the field structures "
                                 "differ")
        agree = float(((dres.pfof > 0) == (one.pfof > 0)).mean())
        log(f"phase 10 {label} substructure path with the sharded density: "
            f"field structures equal; {int((dres.parent[1:] > 0).sum())} "
            f"substructures (one device {int((one.parent[1:] > 0).sum())});"
            f" tagged-state agreement {agree:.5f}; {dt:.3f} s")

        pgot = find_structures(planted_options(C, G_KMS), ppos, pvel, pmass,
                               boxsize=16.0, mesh=mesh)
        msg = check_mesh_catalog(np, pgot, pone, ppos, pvel, pmass,
                                 planted_options(C, G_KMS),
                                 f"planted subhalos ({label})")
        log(f"phase 10 {label} planted subhalos: {msg}; {nsub} "
            "substructures")

        t0 = time.perf_counter()
        dm = distributed_localfield.distributed_velocity_density(
            dpos, dvel, mesh, boxsize=box).cpu().numpy()
        dt = time.perf_counter() - t0
        med = float(np.median(np.abs(np.log(dm) - np.log(d1))))
        k = DENSITY_N // 20
        overlap = len(set(np.argsort(-d1)[:k]) &
                      set(np.argsort(-dm)[:k])) / k
        ratio = float(np.median(dm[:nclump]) / np.median(dm[nclump:]))
        if not ((dm > 0).all() and med < 0.2 and overlap > 0.9 and
                ratio > 10):
            raise AssertionError(f"sharded density ({label}): median |log "
                                 f"ratio| {med}, top-5% overlap {overlap}, "
                                 f"clump / background {ratio}")
        log(f"phase 10 {label} sharded density at n={DENSITY_N}: median "
            f"|log ratio| {med:.4f}, top-5% overlap {overlap:.4f}, clump / "
            f"background {ratio:.1f}; one device {t_one:.3f} s, mesh "
            f"{dt:.3f} s")


EXAMPLE_BOX = 100.0
EXAMPLE_N = 128 ** 3        # phase 11's uniform background particles
# phase 11's planted hosts (4^3 on a lattice 20 apart, a subhalo each),
# small halos and zoom low-resolution particles at EXAMPLE_N
EXAMPLE_BIG = dict(nhosts=64, nbg=EXAMPLE_N, boxsize=EXAMPLE_BOX,
                   spacing=20.0, nsmall=256, seed=40)
EXAMPLE_BIG_LOWRES = 65536
# each runnable config under examples/, its input and the route a user
# drives it by (the swift 3D config through the library API, as
# tests/test_examples.py runs it)
EXAMPLE_CONFIGS = (
    ("sample_dmcosmological_run.cfg", "dm", "cli"),
    ("genesis2019_configuration.cfg", "dm", "cli"),
    ("sample_eaglehydro_6dfof_subhalo.cfg", "hydro", "cli"),
    ("sample_swifthydro_6dfof_subhalo.cfg", "hydro", "cli"),
    ("sample_swifthydro_3dfof_subhalo.cfg", "hydro", "api"),
    ("sample_zoomhydrocosmological_run.cfg", "zoom", "cli"),
)
EXAMPLE_REFUSED = "sample_zoom_run.cfg"


def example_particles(np, kind: str, big: bool):
    """(pos, vel, mass, ptype, box) of phase 11's input of ``kind``."""
    from velociraptor_stf_tpu_torch.io.synthetic import (EXAMPLE_BOXSIZE,
                                                         example_snapshot)

    # small: example_snapshot's defaults, the CPU tests' input
    kw = dict(EXAMPLE_BIG) if big else {}
    if kind == "zoom" and big:
        kw["nlowres"] = EXAMPLE_BIG_LOWRES
    pos, vel, mass, ptype = example_snapshot(kind, **kw)
    return pos, vel, mass, ptype, kw.get("boxsize", EXAMPLE_BOXSIZE)


def write_example(np, path: Path, parts) -> str:
    from velociraptor_stf_tpu_torch.io import gadget

    pos, vel, mass, ptype, box = parts
    gadget.write_gadget(str(path), pos, vel, np.arange(1, len(pos) + 1),
                        ptype, mass, boxsize=box, time=1.0, omega0=0.3,
                        omega_lambda=0.7, hubble=0.7)
    return str(path)


class ApiCatalog:
    """What ``invoke`` returns, with the hierarchy's levels derived from
    the parents (the API returns no levels and no potentials): a field
    structure is at level 0, a substructure whose parent the combined
    unbind dissolved (parent 0, hostid not -1) at level 1."""

    def __init__(self, np, out: dict):
        self.pfof = np.asarray(out["group_id"])
        self.ngroups = int(out["ngroups"])
        self.props = out["properties"]
        self.hostid = np.asarray(out["hostid"])
        self.parent = np.asarray(out["parent"], np.int64)
        level = np.where((self.parent == 0) & (self.hostid >= 0), 1, 0)
        level[0] = 0
        for _ in range(len(level)):
            nxt = np.where(self.parent > 0, level[self.parent] + 1, level)
            if np.array_equal(nxt, level):
                break
            level = nxt
        self.hierarchy_level = level.astype(np.int32)
        self.W, self.timings = None, {}


def run_example(torch, np, dev, C, name: str, route: str, snap: str,
                parts, out: str):
    """One config as a user drives it: the CLI's run (``cli.run`` after
    ``main``'s parsing and checks) on the gadget snapshot, or the library
    API on the particles as tensors on ``dev``.  The config is used as
    shipped apart from its input and output names and binary catalogs
    (the card's machine has no h5py).  Returns (catalog, options,
    (pos, vel, mass, ptype) as the search saw them)."""
    from velociraptor_stf_tpu_torch import api, cli

    cfg = str(REPO / "examples" / name)
    if route == "cli":
        opt = C.parse_config_file(cfg)
        opt.fname, opt.inputtype, opt.outname = snap, C.IOGADGET, out
        opt.ibinaryout = C.OUTBINARY
        C.config_check(opt, strict=True)
        res = cli.run(opt, device=dev)
        pos, vel, _, ptype, mass, _, _ = cli.read_snapshot(opt)
        return res, opt, (pos, vel, mass, ptype)
    pos, vel, mass, ptype, box = parts
    session = api.VelociraptorSession(config=cfg)
    session.opt.ibinaryout = C.OUTBINARY
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
         for a in (pos, vel, mass)]
    n = len(pos)
    got = session.invoke(
        *t, pids=np.arange(1, n + 1), ptype=ptype,
        sim=api.SimInfo(period=box, interparticlespacing=box / n ** (1 / 3),
                        icosmologicalsim=1),
        outname=out, write_output=True, device=dev)
    return ApiCatalog(np, got), session.opt, (pos, vel, mass, ptype)


def check_example_catalog(np, res, n: int) -> None:
    """Ids 0..ngroups for every particle, ngroups + 1 rows of properties,
    the bulk ones finite for every group with members (a substructure
    can lose every member to the unbind, in the JAX package too: ROADMAP
    queue 3), finite potentials where the run returns them."""
    if res.pfof.shape != (n,) or res.ngroups <= 0:
        raise AssertionError(f"examples: {res.ngroups} groups, ids of "
                             f"shape {res.pfof.shape} for {n} particles")
    sizes = np.bincount(res.pfof.astype(np.int64),
                        minlength=res.ngroups + 1)
    if sizes.shape[0] != res.ngroups + 1:
        raise AssertionError("examples: group ids out of range")
    for k, v in res.props.items():
        if np.asarray(v).shape[0] != res.ngroups + 1:
            raise AssertionError(f"examples: property {k} has "
                                 f"{np.asarray(v).shape[0]} rows")
    held = sizes > 0
    for k in ("num", "gmass", "gcm", "gcmvel", "gsize", "gRhalfmass",
              "gmaxvel", "gveldisp"):
        if not np.isfinite(np.asarray(res.props[k])[held]).all():
            raise AssertionError(f"examples: property {k} not finite")
    if res.W is not None and not np.isfinite(res.W).all():
        raise AssertionError("examples: non-finite W")


def examples_case(torch, np, dev, C, kernels, report) -> None:
    """Phase 11: every runnable config under examples/ on the card at
    EXAMPLE_N uniform particles with planted subhalos (gas copies for the
    hydro configs, low-resolution particles for the zoom config), as a
    user runs it; its invariants; its ids and hierarchy on the CPU tests'
    input against the plain versions on the host; genesis over a mesh of
    four shards on the card against one card; the refused config."""
    from velociraptor_stf_tpu_torch import cli
    from velociraptor_stf_tpu_torch.models.pipeline import (
        find_structures, search_and_unbind)
    from velociraptor_stf_tpu_torch.parallel.mesh import Mesh

    tmp = Path(tempfile.mkdtemp(prefix="vr_examples_"))
    try:
        big, snaps = {}, {}
        t0 = time.perf_counter()
        for kind in ("dm", "hydro", "zoom"):
            big[kind] = example_particles(np, kind, True)
            snaps[kind] = write_example(np, tmp / f"{kind}.gdt", big[kind])
        log(f"phase 11 inputs: " + ", ".join(
            f"{k} {len(p[0])} particles ({int((p[3] == 0).sum())} gas, "
            f"{int((p[3] == 2).sum())} low-resolution)"
            for k, p in big.items()) +
            f"; written in {time.perf_counter() - t0:.1f} s")

        # every config once at full width; the kernels' counts over these
        # runs only
        kernels.reset_launches()
        runs = {}
        for name, kind, route in EXAMPLE_CONFIGS:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            out = str(tmp / name.split(".")[0])
            t0 = time.perf_counter()
            res, opt, parts = run_example(torch, np, dev, C, name, route,
                                          snaps[kind], big[kind], out)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            runs[name] = (res, opt, parts, out, kind, route)
            nsub = int((np.asarray(res.parent)[1:] > 0).sum())
            st = {k: round(v, 4) for k, v in res.timings.items()}
            log(f"phase 11 {name} ({route}): {res.ngroups} groups, {nsub} "
                f"substructures, wall {wall:.3f} s, stages {json.dumps(st)}"
                f", peak memory {peak:.2f} GiB")
        counts = dict(kernels.LAUNCHES)
        log(f"phase 11 launches over the six runs {json.dumps(counts)}")
        missing = [k for k, v in counts.items() if v <= 0]
        if missing:
            raise AssertionError(f"examples: kernels not launched "
                                 f"{missing}")
        for e in report:
            e["launches_examples"] = counts[e["name"]]

        for name, (res, opt, parts, out, kind, route) in runs.items():
            pos, vel, mass, ptype = parts
            check_example_catalog(np, res, len(pos))
            deepest = check_hierarchy(np, res, C.MAXSUBLEVEL,
                                      orphans=bool(opt.iBaryonSearch))
            nsub = int((res.parent[1:] > 0).sum())
            if nsub < 1:
                raise AssertionError(f"{name}: no substructure found")
            lone = int(((res.parent[1:] == 0) &
                        (res.hierarchy_level[1:] > 0)).sum())
            msg = [f"hierarchy to level {deepest}" + (
                f", {lone} substructures whose parent the combined "
                "unbind dissolved" if lone else "")]
            if res.W is not None and opt.iBaryonSearch:
                # every group is unbound once more in its own frame
                loose = unbound_members(np, res.pfof.astype(np.int64), mass,
                                        vel, res.W, opt.uinfo.Eratio)
                if loose.any():
                    raise AssertionError(f"{name}: {int(loose.sum())} "
                                         "grouped particles unbound")
                msg.append(f"all {int((res.pfof > 0).sum())} members bound")
            elif res.W is not None and opt.iBoundHalos >= 1:
                nb = check_bound_tops(np, res, mass, vel, opt.uinfo.Eratio)
                msg.append(f"all {nb} members of top-level structures "
                           "bound")
            if opt.iBaryonSearch:
                nb = int(((ptype != 1) & (res.pfof > 0)).sum())
                subs = np.nonzero(res.parent[1:] > 0)[0] + 1
                insub = int(np.isin(res.pfof[ptype == 0], subs).sum())
                if not insub:
                    raise AssertionError(f"{name}: no gas in a "
                                         "substructure")
                msg.append(f"{nb} baryons in groups, {insub} gas "
                           "particles in substructures; " +
                           check_association(torch, np, dev, opt, pos, vel,
                                             mass, ptype))
            if kind == "zoom":
                nlr = int(((ptype == 2) & (res.pfof > 0)).sum())
                if nlr < 1 or not (res.props["n_interloper"][1:] > 0).any():
                    raise AssertionError(f"{name}: no interloper")
                msg.append(f"{nlr} low-resolution particles in groups")
            check_cli_files(np, out, res.ngroups, len(pos),
                            len(opt.profile_bin_edges) if opt.iprofilecalc
                            else None, hierarchy=route == "cli",
                            sizes_want=np.bincount(
                                res.pfof.astype(np.int64),
                                minlength=res.ngroups + 1)[1:])
            msg.append("catalog files parse")
            if name.startswith("genesis"):
                sres = search_and_unbind(opt, pos, vel, mass,
                                         boxsize=EXAMPLE_BOX, device=dev)
                top = int(sres.pfof_fof.max())
                if not (0 < top <= sres.ngroups_fof < sres.ngroups):
                    raise AssertionError(
                        f"{name}: inclusive masses from ids up to {top} "
                        f"against {sres.ngroups_fof} field halos")
                msg.append(f"inclusive masses from the {sres.ngroups_fof} "
                           f"field halos' ids (largest {top})")
                t0 = time.perf_counter()
                mres = find_structures(opt, pos, vel, mass,
                                       boxsize=EXAMPLE_BOX,
                                       mesh=Mesh((dev,) * MESH_SHARDS))
                torch.cuda.synchronize()
                msg.append(f"over {MESH_SHARDS} shards on the card "
                           f"({time.perf_counter() - t0:.2f} s): " +
                           check_mesh_catalog(np, mres, res, pos, vel, mass,
                                              opt, f"{name} mesh"))
                del mres, sres
            log(f"phase 11 {name}: " + "; ".join(msg))
        del runs

        # the CPU tests' inputs: the card's ids and hierarchy are the plain
        # versions' on the host
        for name, kind, route in EXAMPLE_CONFIGS:
            parts = example_particles(np, kind, False)
            snap = write_example(np, tmp / f"{kind}_small.gdt", parts)
            got, want = (run_example(torch, np, d, C, name, route, snap,
                                     parts, str(tmp / f"small_{d.type}"))[0]
                         for d in (dev, torch.device("cpu")))
            same = got.ngroups == want.ngroups and \
                np.array_equal(got.pfof, want.pfof) and all(
                    np.array_equal(getattr(got, k), getattr(want, k))
                    for k in ("hostid", "parent", "hierarchy_level"))
            nsub = int((want.parent[1:] > 0).sum())
            if not same or nsub < 1:
                raise AssertionError(
                    f"{name} on {len(parts[0])} particles: card "
                    f"{got.ngroups} groups, host {want.ngroups}; "
                    f"{int((got.pfof != want.pfof).sum())} ids differ; "
                    f"{nsub} substructures")
            log(f"phase 11 {name} at n={len(parts[0])}: {want.ngroups} "
                f"groups, {nsub} substructures; ids, parent, hostid and "
                "level equal on the card and on the CPU")

        cfg = str(REPO / "examples" / EXAMPLE_REFUSED)
        try:
            cli.main(["-C", cfg, "-i", snaps["hydro"], "-o",
                      str(tmp / "refused"), "--device", dev.type])
        except ValueError as e:
            if "Baryon_searchflag requires Particle_search_type" not in \
                    str(e):
                raise
            log(f"phase 11 {EXAMPLE_REFUSED} refused: {e}")
        else:
            raise AssertionError(f"{EXAMPLE_REFUSED} was not refused")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=256 ** 3,
                    help="particles of the main-path run (default 256^3)")
    ap.add_argument("--cli-n", type=int, default=128 ** 3,
                    help="particles of the CLI phase's snapshot "
                    "(default 128^3)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2

    import numpy as np

    from velociraptor_stf_tpu_torch import kernels
    from velociraptor_stf_tpu_torch.io.synthetic import make_cosmo_mock
    from velociraptor_stf_tpu_torch.kernels import _build
    from velociraptor_stf_tpu_torch.models.pipeline import (find_structures,
                                                           search_and_unbind)
    from velociraptor_stf_tpu_torch.utils import config as C
    from velociraptor_stf_tpu_torch.utils import units
    from velociraptor_stf_tpu_torch.validation import oracles

    dev = torch.device("cuda")
    card = card_info()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = _build.build()
    log(f"phase 1 build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    build_log = lib.with_suffix(".log").read_text()
    log(build_log.strip())
    ptxas = ptxas_report(build_log)
    sass = sass_per_pair(lib)
    for name, (per_pair, loop, pairs) in sass.items():
        log(f"SASS {name}: hot loop of {loop} instructions for {pairs} "
            f"pairs, {per_pair:.4g} lane-arithmetic instructions per pair")

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
    check_kernels(torch, np, tpos, tvel, tmass, opt, sass, ptxas, report)
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
            digest = hashlib.sha256(res.pfof.tobytes() + res.W.tobytes())
            log(f"phase 4 run {rep} ({'warm-up' if rep == 0 else 'timed'}): "
                f"ngroups {res.ngroups} timings {json.dumps(res.timings)} "
                f"wall {wall:.3f} s fof+unbind {n / metric:.1f} particles/s "
                f"ids and potentials sha256 {digest.hexdigest()[:16]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"launches {json.dumps(counts)} peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; two runs "
        f"equal bit for bit ({len(res.props)} property arrays)")
    log(f"field search alone (inputs on the card): peak memory "
        f"{fof_peak_gib(torch, opt, pos, vel, mass, dev):.2f} GiB")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    for e in report:
        e["launches"] = counts[e["name"]]

    main_cat = res
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

    t0 = time.perf_counter()
    hydro_counts = hydro_case(torch, np, dev, C, kernels, pos, vel, mass, n)
    for e in report:
        e["launches_hydro"] = hydro_counts[e["name"]]
    log(f"phase 8 hydro path: ok in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    sub_counts = subsub_case(torch, np, dev, C, kernels, pos, vel, mass, n)
    for e in report:
        e["launches_subsub"] = sub_counts[e["name"]]
    log(f"phase 9 substructure path: ok in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    mesh_case(torch, np, dev, C, kernels, pos, vel, mass, n, main_cat,
              report)
    del main_cat
    log(f"phase 10 mesh path: ok in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    examples_case(torch, np, dev, C, kernels, report)
    log(f"phase 11 example configs: ok in {time.perf_counter() - t0:.1f} s")
    log(f"gpu: {card}")
    log(json.dumps({"kernels": report}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
