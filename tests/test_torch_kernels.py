"""The port's kernel wrappers (velociraptor_stf_tpu_torch/kernels) on small
inputs: argument checks, the plain versions against brute force, and --
on a GPU -- each CUDA kernel against its plain version.

This file imports no jax, so the GPU tests run on a machine without it:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

(``--noconftest``: tests/conftest.py imports jax.)  Without a CUDA device
the ``gpu`` tests skip.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from velociraptor_stf_tpu_torch.kernels import R_BLOCK
from velociraptor_stf_tpu_torch.kernels import fof_sweep as KF
from velociraptor_stf_tpu_torch.kernels import potential as KP
from velociraptor_stf_tpu_torch.kernels._common import pair_d2, window_tiles
from velociraptor_stf_tpu_torch.ops import fof_sweep as TF
from velociraptor_stf_tpu_torch.ops import gravity_direct
from velociraptor_stf_tpu_torch.ops import segments as seg


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cloud(seed=0, n=3000, box=10.0):
    """Clumped points in a non-periodic box, cell-sorted for linking length
    0.15."""
    rng = np.random.default_rng(seed)
    pos = np.vstack([rng.normal(3.0, 0.2, (n // 2, 3)),
                     rng.uniform(0, box, (n - n // 2, 3))]).astype(np.float32)
    ll = 0.15
    ctx, _ = TF.build_fof_ctx(torch.from_numpy(pos), None, ll)
    return ctx, ll


def _detect_args(ctx):
    """(pts, col, colstart, ny) of ``detect`` on a context, as
    ``SweepFof.linked_mask`` forms them."""
    _, ny, nz = ctx.ncells
    col, colstart = ctx.detect_index
    return KF.pack(ctx.pos.T, (ctx.cr % nz).int()), col, colstart, ny


def _brute_d2(p):
    d = p[:, None, :] - p[None, :, :]
    d2 = d[..., 0] * d[..., 0]
    d2 = d2 + d[..., 1] * d[..., 1]
    return d2 + d[..., 2] * d[..., 2]


def test_plain_fof_versions_match_brute_force():
    ctx, ll = _cloud()
    p = ctx.pos.T
    b2 = KF.f32(ll * ll)
    link = _brute_d2(p) <= b2
    cnt = KF.detect_ref(*_detect_args(ctx), b2)
    assert torch.equal(cnt, link.sum(1, dtype=torch.int32))
    lab = torch.randperm(ctx.ns, generator=torch.Generator().manual_seed(1)
                         ).int()
    want = torch.where(link, lab[None, :], KF.BIG_I32).amin(1).int()
    cell, win = ctx.sweep_windows
    pts = KF.pack(p)
    assert torch.equal(pts[:, :3], p) and not pts[:, 3].any()
    assert torch.equal(KF.sweep3d_ref(pts, lab, cell, win, b2), want)
    # 6D: same nonzero group, phase criterion with per-row scales
    rng = np.random.default_rng(2)
    vel = torch.from_numpy(rng.normal(0, 1, (ctx.ns, 3)).astype(np.float32))
    grp = torch.from_numpy(rng.integers(0, 3, ctx.ns).astype(np.int32))
    rivs = torch.from_numpy(rng.uniform(0.5, 2, ctx.ns).astype(np.float32))
    inv_b2 = KF.f32(1.0 / (ll * ll))
    phase = _brute_d2(p) * inv_b2 + _brute_d2(vel) * rivs[:, None]
    ok = (phase <= 1.0) & (grp[:, None] == grp[None, :]) & (grp[:, None] > 0)
    want6 = torch.minimum(lab, torch.where(ok, lab[None, :],
                                           KF.BIG_I32).amin(1).int())
    pts6, vels = KF.pack(p, grp), KF.pack(vel, rivs)
    assert torch.equal(pts6.view(torch.int32)[:, 3], grp)   # bits carried
    assert torch.equal(vels[:, 3], rivs)
    got6 = KF.sweep6d_ref(pts6, vels, lab, cell, win, inv_b2)
    assert torch.equal(got6, want6)


def _faces(seed=8, box=6.0):
    """Uniform points plus points on every face, edge and corner of the
    box, so rows sit in every outer cell of the open grid."""
    rng = np.random.default_rng(seed)
    k = np.array([0.0, box / 2, box])
    lattice = np.stack(np.meshgrid(k, k, k), -1).reshape(-1, 3)
    face = rng.uniform(0, box, (600, 3))
    face[np.arange(600), rng.integers(0, 3, 600)] = \
        rng.choice([0.0, box], 600)
    return np.vstack([lattice, face, rng.uniform(0, box, (900, 3))]
                     ).astype(np.float32)


def _geometry(name):
    """(context, grid, reach) of a clustered periodic box with ghosts, an
    open box, the box-face points, or a slab one cell thick along an
    axis."""
    rng = np.random.default_rng(7)
    if name == "clumped_periodic":
        box, reach = 10.0, 0.4
        pos = np.vstack([rng.normal(5.0, 0.3, (1000, 3)),
                         rng.normal(0.2, 0.3, (500, 3)) % box,
                         rng.uniform(0, box, (1000, 3))]).astype(np.float32)
        ctx, grid = TF.build_fof_ctx(torch.from_numpy(pos), box, reach)
        assert (~ctx.is_real).any()                  # ghosts in outer cells
    elif name.startswith("thin_"):
        reach = 0.4
        pos = np.vstack([rng.normal(3.0, 0.3, (600, 3)),
                         rng.uniform(0, 10, (900, 3))])
        axis = "xyz".index(name[-1])
        pos[:, axis] = rng.uniform(0, 0.3, len(pos))
        ctx, grid = TF.build_fof_ctx(
            torch.from_numpy(pos.astype(np.float32)), None, reach)
        assert grid.ncells[axis] == 1
    else:
        reach = 0.4 if name == "open" else 0.5
        pos = (np.vstack([rng.normal(3.0, 0.3, (1200, 3)),
                          rng.uniform(0, 10, (1200, 3))]).astype(np.float32)
               if name == "open" else _faces())
        ctx, grid = TF.build_fof_ctx(torch.from_numpy(pos), None, reach)
    assert grid.ncells == ctx.ncells
    return ctx, grid, reach


@pytest.mark.parametrize("geometry", ["clumped_periodic", "open", "faces",
                                      "thin_x", "thin_y", "thin_z"])
def test_column_index_is_exact(geometry):
    """Each z-column's range holds exactly its slots, sorted on their z
    cell, and an empty column has an empty range; the windows a row scans
    through the index are disjoint and hold exactly the slots of its 27
    cells; the plain detect counts equal brute force."""
    ctx, grid, reach = _geometry(geometry)
    nx, ny, nz = grid.ncells
    col, colstart = TF.column_index(ctx.cx, ctx.cr, grid.ncells)
    assert col.dtype == colstart.dtype == torch.int32
    assert colstart.shape == (nx * ny + 1,)
    c = np.stack([ctx.cx.numpy(), ctx.cr.numpy() // nz,
                  ctx.cr.numpy() % nz], 1)
    np.testing.assert_array_equal(col.numpy(), c[:, 0] * ny + c[:, 1])
    occupancy = np.bincount(col.numpy(), minlength=nx * ny)
    np.testing.assert_array_equal(np.diff(colstart.numpy()), occupancy)
    assert colstart[0] == 0 and colstart[-1] == ctx.ns
    if geometry in ("clumped_periodic", "open"):
        assert (occupancy == 0).any()               # empty z-columns
    for k in np.nonzero(occupancy)[0][:200]:
        rows = slice(int(colstart[k]), int(colstart[k + 1]))
        assert (col.numpy()[rows] == k).all()
        assert (np.diff(c[rows, 2]) >= 0).all()
    pts, col, colstart, ny = _detect_args(ctx)
    assert torch.equal(pts.view(torch.int32)[:, 3],
                       torch.from_numpy(c[:, 2]).int())
    ns = ctx.ns
    w = KF.column_windows(pts, col, colstart, ny, 0, ns).numpy()
    rows = np.repeat(np.arange(ns), 9)
    diff = np.zeros((ns, ns + 1), np.int32)
    np.add.at(diff, (rows, w[:, :, 0].ravel()), 1)
    np.add.at(diff, (rows, (w[:, :, 0] + w[:, :, 1]).ravel()), -1)
    cover = np.cumsum(diff, 1)[:, :ns]
    assert cover.max() == 1                                  # disjoint
    near = (np.abs(c[:, None, :] - c[None, :, :]) <= 1).all(-1)
    np.testing.assert_array_equal(cover == 1, near)         # the 27 cells
    assert (w[:, :, 1] == 0).any()          # some z-column off the grid
    # rows [r0, r1) alone give the same windows
    np.testing.assert_array_equal(
        KF.column_windows(pts, col, colstart, ny, 100, 300).numpy(),
        w[100:300])
    b2 = KF.f32(reach * reach)
    want = (_brute_d2(ctx.pos.T) <= b2).sum(1, dtype=torch.int32)
    assert torch.equal(KF.detect_ref(pts, col, colstart, ny, b2), want)
    assert torch.equal(KF.detect_ref(pts, col, colstart, ny, b2,
                                     rows_per_batch=257), want)
    assert (want >= 2).any() and (want == 1).any()


def test_detect_counts_nothing_in_an_emptied_column():
    """Z-columns whose range is emptied in the index give no count: with
    the last two x-stripes emptied, the rows of the last stripe (whose
    every neighbour column is empty) count 0, and the rest lose exactly
    their neighbours in those stripes."""
    ctx, grid, reach = _geometry("open")
    nx, ny, nz = grid.ncells
    pts, col, colstart, ny = _detect_args(ctx)
    b2 = KF.f32(reach * reach)
    emptied = colstart.clone()
    emptied[(nx - 2) * ny:] = colstart[(nx - 2) * ny]
    got = KF.detect(pts, col, emptied, ny, b2)
    link = _brute_d2(ctx.pos.T) <= b2
    link &= (ctx.cx < nx - 2)[None, :]
    assert torch.equal(got, link.sum(1, dtype=torch.int32))
    last = ctx.cx == nx - 1
    assert last.any() and not got[last].any()
    assert got[ctx.cx == nx - 3].any()


@pytest.mark.parametrize("geometry", ["clumped_periodic", "open", "faces"])
def test_cell_windows_are_exact(geometry):
    """Every row's nine cell windows are disjoint, hold exactly the slots
    of the 27 cells around its cell (so their total length is those
    cells' occupancy), and so every slot within reach; z-columns off the
    grid and z beyond its ends add nothing."""
    ctx, grid, reach = _geometry(geometry)
    nx, ny, nz = grid.ncells
    cell, win = TF.cell_windows(ctx.cx, ctx.cr, grid.ncells)
    assert cell.dtype == win.dtype == torch.int32
    assert win.shape == (int(cell.max()) + 1, 9, 2)
    c = np.stack([ctx.cx.numpy(), ctx.cr.numpy() // nz,
                  ctx.cr.numpy() % nz], 1)
    for axis, n in enumerate((nx, ny, nz)):
        assert c[:, axis].min() == 0 and c[:, axis].max() == n - 1
    ns = ctx.ns
    w = win.long().numpy()[cell.long().numpy()]          # (ns, 9, 2)
    rows = np.repeat(np.arange(ns), 9)
    diff = np.zeros((ns, ns + 1), np.int32)
    np.add.at(diff, (rows, w[:, :, 0].ravel()), 1)
    np.add.at(diff, (rows, (w[:, :, 0] + w[:, :, 1]).ravel()), -1)
    cover = np.cumsum(diff, 1)[:, :ns]
    assert cover.max() == 1                                  # disjoint
    near = (np.abs(c[:, None, :] - c[None, :, :]) <= 1).all(-1)
    np.testing.assert_array_equal(cover == 1, near)         # the 27 cells
    np.testing.assert_array_equal(w[:, :, 1].sum(1), near.sum(1))
    d2 = _brute_d2(ctx.pos.T.double()).numpy()
    assert cover[d2 <= reach * reach].all()
    assert (w[:, :, 1] == 0).any()          # some z-column off the grid


def _grouped(seed=3):
    """Group-sorted particles: a gid-0 run first, groups of assorted sizes,
    the largest group at the array tail."""
    rng = np.random.default_rng(seed)
    sizes = [700, 1, 40, 300, 2, 900]
    g = np.concatenate([np.zeros(500, np.int64)] +
                       [np.full(s, i + 1) for i, s in enumerate(sizes)])
    pos = rng.normal(0, 1, (len(g), 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2, len(g)).astype(np.float32)
    return torch.from_numpy(pos), torch.from_numpy(mass), torch.from_numpy(g)


def test_plain_potential_matches_brute_force():
    pos, mass, g = _grouped()
    offsets = seg.group_offsets(g, int(g.max()))
    win = gravity_direct.block_window(g, offsets)
    assert not win[g == 0].any()              # gid-0 rows: no window
    eps2 = KP.f32(1e-4)
    got = KP.potential_ref(pos.T.contiguous(), mass, g.int(), win, eps2)
    p = pos.double()
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1) + eps2
    same = (g[:, None] == g[None, :]) & (g[:, None] > 0)
    same.fill_diagonal_(False)
    want = torch.where(same, mass.double()[None, :] / d2.sqrt(), 0.0).sum(1)
    assert torch.equal(got[g == 0], torch.zeros(int((g == 0).sum())))
    nz = want != 0
    assert float(((got.double() - want)[nz] / want[nz]).abs().max()) < 1e-5


def _plain_before(pos, mass, g, offsets, eps2):
    """The plain version over the per-block windows of the earlier
    kernel: [offsets[gmin], offsets[gmax + 1]) of each R_BLOCK-row block's
    nonzero gids."""
    ns = len(g)
    nb = -(-ns // R_BLOCK)
    gb = torch.zeros(nb * R_BLOCK, dtype=torch.int64)
    gb[:ns] = g
    gb = gb.view(nb, R_BLOCK)
    gmin = torch.where(gb > 0, gb, 2**62).amin(1)
    gmax = gb.amax(1)
    last = offsets.shape[0] - 1
    s = offsets[gmin.clamp(max=last)]
    e = offsets[(gmax + 1).clamp(max=last)]
    has = gmax > 0
    win = torch.stack([torch.where(has, s, 0), torch.where(has, e - s, 0)],
                      -1).view(nb, 1, 2).int()
    p = pos.T.contiguous()
    acc = torch.zeros(ns, dtype=torch.float64)
    gi = g.int()
    for rows, rvalid, cols, cvalid in window_tiles(win, ns):
        gr = gi[rows][:, :, None]
        hit = ((gr == gi[cols][:, None, :]) & (gr > 0) &
               (rows[:, :, None] != cols[:, None, :]) & cvalid[:, None, :])
        term = mass[cols][:, None, :] * torch.rsqrt(
            pair_d2(p, rows, cols) + eps2)
        acc[rows[rvalid]] += torch.where(hit, term, 0.0).sum(-1)[
            rvalid].double()
    return acc.float()


@pytest.mark.parametrize("rows", ["block", "thread"])
def test_potential_spans_cover_needed_pairs(rows):
    """The column span of every row block (and of every thread's rows)
    holds every needed pair (same gid > 0, i != j) of its rows, and no
    row of gid 0 widens it."""
    pos, mass, g, offsets = KP.edge_case()
    win = gravity_direct.block_window(g, offsets)
    per = KP.ROWS_PER_BLOCK if rows == "block" else KP.ROWS_PER_THREAD
    sp = KP.spans(win, per)
    assert sp.shape == (-(-len(g) // per), 2)
    gi = g.numpy()
    for i in np.nonzero(gi > 0)[0]:
        lo, hi = (int(v) for v in sp[i // per])
        partners = np.nonzero(gi == gi[i])[0]
        assert lo <= partners.min() and partners.max() < hi, i
        assert tuple(win[i].tolist()) == (partners.min(), partners.max() + 1)
    # blocks of gid-0 rows only scan nothing; spans end at groups' ends
    only0 = [b for b in range(sp.shape[0])
             if not (gi[b * per:(b + 1) * per] > 0).any()]
    assert only0 and not sp[only0].any()
    ends = set(offsets.tolist())
    assert all(int(h) in ends for lo, h in sp.tolist() if h > lo)
    # pairs the kernel evaluates: each thread's rows against its span
    assert KP.pairs_tested(win) >= int(sum(
        s * (s - 1) for s in np.bincount(gi[gi > 0])))


@pytest.mark.parametrize("chunks", ["whole", "one tile"])
def test_potential_work_items_tile_spans(monkeypatch, chunks):
    """The work items cut each row block's span, widened down to a
    multiple of the tile, into chunks of whole tiles, in order, without
    gap or overlap; an empty span keeps one empty item.  At the real sizes
    this case's spans are under one chunk each."""
    if chunks == "one tile":
        monkeypatch.setattr(KP, "MIN_CHUNK", KP.TILE)
    pos, mass, g, offsets = KP.edge_case()
    win = gravity_direct.block_window(g, offsets)
    items, first = KP.work_items(win)
    sp = KP.spans(win, KP.ROWS_PER_BLOCK)
    assert items.dtype == first.dtype == torch.int32
    assert first[0] == 0 and first[-1] == items.shape[0]
    assert (first[1:] > first[:-1]).all()
    split = False
    for b in range(sp.shape[0]):
        its = items[int(first[b]):int(first[b + 1])].long()
        assert (its[:, 0] == b).all() and (its[:, 3] == 0).all()
        assert int(its[0, 1]) == int(sp[b, 0]) - int(sp[b, 0]) % KP.TILE \
            and int(its[-1, 2]) == int(sp[b, 1])
        assert (its[:, 1] % KP.TILE == 0).all()
        assert torch.equal(its[1:, 1], its[:-1, 2])
        assert ((its[:-1, 2] - its[:-1, 1]) % KP.TILE == 0).all()
        split |= its.shape[0] > 1
    assert split == (chunks == "one tile")


@pytest.mark.parametrize("eps2", [1e-4, 0.0])
def test_plain_potential_new_windows_equal_before(eps2):
    """The plain version on the row windows equals the plain version on
    the earlier per-block windows (rel 1e-6; +inf where coincident)."""
    pos, mass, g, offsets = KP.edge_case()
    win = gravity_direct.block_window(g, offsets)
    got = KP.potential_ref(pos.T.contiguous(), mass, g.int(), win,
                           KP.f32(eps2)).double()
    want = _plain_before(pos, mass, g, offsets, KP.f32(eps2)).double()
    assert torch.equal(got[g == 0], torch.zeros(int((g == 0).sum()),
                                                dtype=torch.float64))
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf)
    assert bool(inf.any()) == (eps2 == 0.0)
    nz = (want != 0) & ~inf
    assert float(((got - want)[nz] / want[nz]).abs().max()) < 1e-6


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("groups", [False, True])
def test_stencil_pairs_count_each_rows_27_cells(groups):
    """chip_smoke.py's pairs needed by the FOF kernels: for every row, the
    slots of the 27 cells around its cell (itself included), of the same
    nonzero group when groups are given -- against brute force."""
    rng = np.random.default_rng(6)
    pos = np.vstack([rng.normal(3.0, 0.3, (600, 3)),
                     rng.uniform(0, 10, (600, 3))]).astype(np.float32)
    ctx, grid = TF.build_fof_ctx(torch.from_numpy(pos), None, 0.4)
    grp = (torch.from_numpy(rng.integers(0, 4, ctx.ns).astype(np.int32))
           if groups else None)
    got = _chip_smoke().stencil_pairs(ctx.cx, ctx.cr, grid.ncells, grp)
    nz = grid.ncells[2]
    c = torch.stack([ctx.cx, ctx.cr // nz, ctx.cr % nz], 1)
    near = ((c[:, None, :] - c[None, :, :]).abs() <= 1).all(-1)
    if groups:
        near &= (grp[:, None] == grp[None, :]) & (grp[:, None] > 0)
    assert got == int(near.sum()) > ctx.ns // 2
    # the sweeps' cell windows hold exactly the 27 cells' pairs: all of
    # them in 3D, and with groups those pairs are a subset of them
    cell, win = ctx.sweep_windows
    tested = int(win[cell.long(), :, 1].long().sum())
    assert tested == got if not groups else tested > got
    # detect's windows through the column index hold exactly those pairs
    w = KF.column_windows(*_detect_args(ctx), 0, ctx.ns)
    assert int(w[:, :, 1].sum()) == int(near.sum()) if not groups \
        else int(w[:, :, 1].sum()) > got


_SASS = """
        Function : _ZN12_GLOBAL__N_113detect_kernelEPKf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS.128 R4, [UR4] ;
        /*0020*/                   FADD R8, R4, -R9 ;
        /*0030*/                   FMUL R8, R8, R8 ;
        /*0040*/                   FSETP.GTU.AND P0, PT, R8, UR5, PT ;
        /*0050*/                   UIADD3 UR4, UR4, 0x10, URZ ;
        /*0060*/              @!P0 IADD3 R2, R2, 0x1, RZ ;
        /*0070*/                   FSETP.GTU.AND P1, PT, R8, UR6, PT ;
        /*0080*/                @P1 BRA 0x10 ;
        /*0090*/                   FSETP.GTU.AND P0, PT, R8, UR5, PT ;
        /*00a0*/                @P0 BRA 0x90 ;
        /*00b0*/                @P2 BRA 0x0 ;
        /*00c0*/                   EXIT ;
"""


def test_sass_per_pair_reads_the_innermost_scan(monkeypatch):
    """chip_smoke.py's instruction count per pair: the innermost loop with
    the most pair compares, its lane arithmetic (no loads, branches or
    uniform-datapath instructions) over its compares."""
    cs = _chip_smoke()
    sass = _SASS + "".join(_SASS.replace("detect_kernel", k).replace(
        "FSETP", "MUFU" if k == "potential_kernel" else "FSETP")
        for k in ("sweep3d_kernel", "sweep6d_kernel", "potential_kernel"))
    monkeypatch.setattr(cs.subprocess, "run", lambda *a, **k: type(
        "Done", (), {"stdout": sass})())
    got = cs.sass_per_pair(Path("lib.so"))
    # loop 0x10-0x80: FADD, FMUL, 2 FSETP, IADD3 (MUFU not counted)
    assert got["fof_detect"] == (2.5, 8, 2)
    assert got["fof_sweep6d"] == (2.5, 8, 2)
    assert got["potential"] == (1.5, 8, 2)


def test_wrappers_reject_bad_arguments():
    ctx, ll = _cloud(n=600)
    lab = torch.arange(ctx.ns, dtype=torch.int32)
    dpts, col, colstart, ny = _detect_args(ctx)
    cell, win = ctx.sweep_windows
    with pytest.raises(TypeError):
        KF.detect(dpts.double(), col, colstart, ny, ll * ll)
    with pytest.raises(ValueError):                  # unpacked positions
        KF.detect(ctx.pos, col, colstart, ny, ll * ll)
    with pytest.raises(ValueError):                  # not 16-byte aligned
        KF.detect(torch.zeros(ctx.ns * 4 + 1)[1:].view(ctx.ns, 4), col,
                  colstart, ny, ll * ll)
    with pytest.raises(TypeError):
        KF.detect(dpts, col.long(), colstart, ny, ll * ll)
    with pytest.raises(ValueError):
        KF.detect(dpts, col[1:], colstart, ny, ll * ll)
    with pytest.raises(TypeError):
        KF.detect(dpts, col, colstart.long(), ny, ll * ll)
    with pytest.raises(ValueError):                  # not nx * ny + 1 starts
        KF.detect(dpts, col, colstart[:-1], ny, ll * ll)
    with pytest.raises(ValueError):
        KF.detect(dpts, col, colstart, 0, ll * ll)
    with pytest.raises(ValueError):                  # a cell-window array
        KF.detect(dpts, col, win, ny, ll * ll)
    pts = KF.pack(ctx.pos.T)
    vels = KF.pack(torch.zeros(ctx.ns, 3), torch.ones(ctx.ns))
    with pytest.raises(TypeError):
        KF.sweep3d(pts, lab.long(), cell, win, ll * ll)
    with pytest.raises(ValueError):
        KF.sweep3d(pts, lab[::2], cell, win, ll * ll)
    with pytest.raises(TypeError):
        KF.sweep3d(pts.double(), lab, cell, win, ll * ll)
    with pytest.raises(ValueError):
        KF.sweep3d(pts[:, :3], lab, cell, win, ll * ll)
    with pytest.raises(ValueError):                    # not 16-byte aligned
        KF.sweep3d(torch.zeros(ctx.ns * 4 + 1)[1:].view(ctx.ns, 4), lab,
                   cell, win, ll * ll)
    with pytest.raises(TypeError):
        KF.sweep3d(pts, lab, cell.long(), win, ll * ll)
    with pytest.raises(ValueError):
        KF.sweep3d(pts, lab, cell[1:], win, ll * ll)
    with pytest.raises(TypeError):
        KF.sweep3d(pts, lab, cell, win.long(), ll * ll)
    with pytest.raises(ValueError):
        KF.sweep3d(pts, lab, cell, win[:, :8], ll * ll)
    with pytest.raises(ValueError):
        KF.sweep3d(pts, lab, cell, win.reshape(-1, 2), ll * ll)
    with pytest.raises(ValueError):                    # starts without counts
        KF.sweep3d(pts, lab, cell, win[:, :, :1], ll * ll)
    with pytest.raises(ValueError):
        KF.sweep6d(pts, vels[1:], lab, cell, win, 1.0)
    with pytest.raises(TypeError):
        KF.sweep6d(pts, vels.double(), lab, cell, win, 1.0)
    with pytest.raises(ValueError):
        KF.sweep6d(pts, vels, lab, cell, win.transpose(1, 2), 1.0)
    pos, mass, g = _grouped()
    win = gravity_direct.block_window(g, seg.group_offsets(g, int(g.max())))
    with pytest.raises(TypeError):
        KP.potential(pos.T.contiguous(), mass, g, win, 0.0)
    with pytest.raises(ValueError):
        KP.potential(pos.T, mass, g.int(), win, 0.0)   # not contiguous


@pytest.mark.parametrize("fault", ["cell past the table", "negative cell",
                                   "window past the rows", "negative start",
                                   "negative count", "count past the rows"])
@pytest.mark.parametrize("sweep", ["3d", "6d"])
def test_sweeps_reject_windows_out_of_range(sweep, fault):
    """A cell number outside the window table or a window outside the rows
    is refused before any scan (the kernels would read out of bounds),
    also when the windows of a passing call are changed in place."""
    ctx, ll = _cloud(n=600)
    lab = torch.arange(ctx.ns, dtype=torch.int32)
    cell, win = (t.clone() for t in ctx.sweep_windows)
    pts = KF.pack(ctx.pos.T)
    vels = KF.pack(torch.zeros(ctx.ns, 3), torch.ones(ctx.ns))

    def run():
        if sweep == "3d":
            return KF.sweep3d(pts, lab, cell, win, ll * ll)
        return KF.sweep6d(pts, vels, lab, cell, win, 1.0)

    run()
    if fault == "cell past the table":
        cell[5] = win.shape[0]
    elif fault == "negative cell":
        cell[0] = -1
    elif fault == "window past the rows":
        win[int(cell[-1]), 4] = torch.tensor([ctx.ns - 1, 2])
    elif fault == "negative start":
        win[0, 0, 0] = -1
    elif fault == "negative count":
        win[0, 8, 1] = -1
    else:
        win[int(cell[3]), 4, 1] += ctx.ns
    with pytest.raises(ValueError):
        run()


@pytest.mark.parametrize("fault", ["column past the index",
                                   "negative column", "decreasing starts",
                                   "negative start", "start past the rows"])
def test_detect_rejects_an_index_out_of_range(fault):
    """A z-column outside the index, or starts that decrease or leave the
    rows, are refused before any scan (the kernel would read out of
    bounds), also when the index of a passing call is changed in place."""
    ctx, ll = _cloud(n=600)
    pts, col, colstart, ny = _detect_args(ctx)
    col, colstart = col.clone(), colstart.clone()
    KF.detect(pts, col, colstart, ny, ll * ll)
    if fault == "column past the index":
        col[5] = colstart.shape[0] - 1
    elif fault == "negative column":
        col[0] = -1
    elif fault == "decreasing starts":
        c = int(col[ctx.ns // 2])
        colstart[c] = colstart[c + 1] + 1
    elif fault == "negative start":
        colstart[0] = -1
    else:
        colstart[-1] = ctx.ns + 1
    with pytest.raises(ValueError):
        KF.detect(pts, col, colstart, ny, ll * ll)


@pytest.mark.gpu
def test_cuda_fof_kernels_match_plain(cuda):
    ctx, ll = _cloud(n=20000)
    b2 = KF.f32(ll * ll)
    pos = ctx.pos.to(cuda)
    nx, ny, _ = ctx.ncells
    dpts, col, colstart, ny = (t.to(cuda) if isinstance(t, torch.Tensor)
                               else t for t in _detect_args(ctx))
    cnt = KF.detect(dpts, col, colstart, ny, b2)
    assert torch.equal(cnt, KF.detect_ref(dpts, col, colstart, ny, b2))
    assert int(cnt.max()) > 100 and int(cnt.min()) == 1
    emptied = colstart.clone()                # the last two x-stripes
    emptied[(nx - 2) * ny:] = colstart[(nx - 2) * ny]
    cnt = KF.detect(dpts, col, emptied, ny, b2)
    assert torch.equal(cnt, KF.detect_ref(dpts, col, emptied, ny, b2))
    last = (ctx.cx == nx - 1).to(cuda)
    assert bool(last.any()) and int(cnt[last].sum()) == 0
    cell, win = (t.to(cuda) for t in ctx.sweep_windows)
    win = win.clone()
    zero = torch.tensor([0, ctx.ns // 2, ctx.ns - 1], device=cuda)
    win[cell[zero].long()] = 0                # rows whose cells scan nothing
    pts = KF.pack(pos.T)
    lab = torch.randperm(ctx.ns, device=cuda).int()
    got = KF.sweep3d(pts, lab, cell, win, b2)
    assert torch.equal(got, KF.sweep3d_ref(pts, lab, cell, win, b2))
    assert torch.equal(got[zero], lab[zero])
    assert not torch.equal(got, lab)
    gen = torch.Generator(device=cuda).manual_seed(4)
    vel = torch.randn(ctx.ns, 3, device=cuda, generator=gen)
    grp = torch.randint(0, 4, (ctx.ns,), device=cuda, generator=gen,
                        dtype=torch.int32)
    rivs = torch.rand(ctx.ns, device=cuda, generator=gen) + 0.5
    inv_b2 = KF.f32(1.0 / (ll * ll))
    pts6, vels = KF.pack(pos.T, grp), KF.pack(vel, rivs)
    got6 = KF.sweep6d(pts6, vels, lab, cell, win, inv_b2)
    assert torch.equal(got6, KF.sweep6d_ref(pts6, vels, lab, cell, win,
                                            inv_b2))
    assert torch.equal(got6[zero], lab[zero])
    assert not torch.equal(got6, lab)


@pytest.mark.gpu
def test_cuda_potential_matches_plain(cuda):
    pos, mass, g = _grouped()
    offsets = seg.group_offsets(g, int(g.max()))
    args = (pos.T.contiguous().to(cuda), mass.to(cuda), g.int().to(cuda),
            gravity_direct.block_window(g, offsets).to(cuda))
    for eps2 in (0.0, 1e-4):
        got = KP.potential(*args, KP.f32(eps2)).double()
        want = KP.potential_ref(*args, KP.f32(eps2)).double()
        nz = want != 0
        assert torch.equal(got[~nz], want[~nz])
        assert float(((got - want)[nz] / want[nz]).abs().max()) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("eps2", [0.0, 1e-4])
def test_cuda_potential_edge_case_matches_plain(cuda, eps2):
    """The launch geometry's edges on the card: exact zeros on gid-0 rows,
    +inf kept at eps2 = 0, rel 1e-4 elsewhere."""
    pos, mass, g, offsets = KP.edge_case()
    args = (pos.T.contiguous().to(cuda), mass.to(cuda), g.int().to(cuda),
            gravity_direct.block_window(g, offsets).to(cuda))
    got = KP.potential(*args, KP.f32(eps2)).double()
    want = KP.potential_ref(*args, KP.f32(eps2)).double()
    fin = torch.isfinite(want)
    assert torch.equal(got[~fin], want[~fin])
    nz = (want != 0) & fin
    assert torch.equal(got[want == 0], want[want == 0])
    assert float(((got - want)[nz] / want[nz]).abs().max()) < 1e-4


@pytest.mark.gpu
def test_cuda_wrappers_count_launches_and_reject_cpu_windows(cuda):
    from velociraptor_stf_tpu_torch import kernels

    ctx, ll = _cloud(n=2000)
    kernels.reset_launches()
    dpts, col, colstart, ny = _detect_args(ctx)
    KF.detect(dpts.to(cuda), col.to(cuda), colstart.to(cuda), ny, ll * ll)
    assert kernels.LAUNCHES["fof_detect"] == 1
    with pytest.raises(ValueError):
        KF.detect(dpts.to(cuda), col.to(cuda), colstart, ny, ll * ll)
    with pytest.raises(ValueError):
        KF.detect(dpts.to(cuda), col, colstart.to(cuda), ny, ll * ll)
    assert kernels.LAUNCHES["fof_detect"] == 1
    cell, win = ctx.sweep_windows
    pts = KF.pack(ctx.pos.T).to(cuda)
    lab = torch.arange(ctx.ns, dtype=torch.int32, device=cuda)
    KF.sweep3d(pts, lab, cell.to(cuda), win.to(cuda), ll * ll)
    assert kernels.LAUNCHES["fof_sweep3d"] == 1
    with pytest.raises(ValueError):
        KF.sweep3d(pts, lab, cell, win.to(cuda), ll * ll)
    with pytest.raises(ValueError):
        KF.sweep3d(pts, lab, cell.to(cuda), win, ll * ll)
    assert kernels.LAUNCHES["fof_sweep3d"] == 1


@pytest.mark.gpu
def test_cuda_hydro_path_matches_cpu(cuda):
    """The pair pipeline and the hydro find_structures on the card
    against the same calls on the CPU: edge sets, group ids and baryon
    assignments exactly equal; every kernel launched, the potential for
    the field and for the combined unbind."""
    from velociraptor_stf_tpu_torch import kernels
    from velociraptor_stf_tpu_torch.io.synthetic import make_cosmo_mock
    from velociraptor_stf_tpu_torch.models.baryons import search_baryons
    from velociraptor_stf_tpu_torch.models.pipeline import find_structures
    from velociraptor_stf_tpu_torch.ops import fof
    from velociraptor_stf_tpu_torch.utils import config as C

    n, box = 1 << 16, 40.0
    pos, vel, mass = make_cosmo_mock(n, boxsize=box, nhalos=24, seed=5)
    ptype = np.where(np.arange(len(pos)) % 6 == 5, 0, 1).astype(np.int8)
    ptype[11::12] = 4
    opt = C.Options()
    opt.ellphys = 0.2
    opt.ellxscale = box / n ** (1 / 3)
    opt.fofbgtype = C.FOF6D
    opt.MinSize = 20
    opt.uinfo.unbindflag = 1
    opt.iBoundHalos = 1
    opt.G = 43.0211349
    opt.iSubSearch = 0
    opt.iBaryonSearch = 1
    opt.partsearchtype = C.PSTALL
    C.config_check(opt)
    extras = {"u": np.ones(len(pos), np.float32)}
    want = find_structures(opt, pos, vel, mass, boxsize=box, ptype=ptype,
                           extras=extras, device="cpu")
    kernels.reset_launches()
    got = find_structures(opt, pos, vel, mass, boxsize=box, ptype=ptype,
                          extras=extras, device=cuda)
    assert got.ngroups == want.ngroups > 0
    np.testing.assert_array_equal(got.pfof, want.pfof)
    assert (got.pfof[ptype != 1] > 0).any()
    np.testing.assert_array_equal(got.props["n_gas"], want.props["n_gas"])
    assert kernels.LAUNCHES["potential"] == 2
    assert all(v > 0 for v in kernels.LAUNCHES.values())

    b = opt.ellphys * opt.ellxscale
    tpos = torch.from_numpy(pos)
    e_cpu = fof.build_edges(tpos, b, boxsize=box)
    e_gpu = fof.build_edges(tpos.to(cuda), b, boxsize=box)
    assert torch.equal(e_gpu.erow.cpu(), e_cpu.erow)
    assert torch.equal(e_gpu.ecol.cpu(), e_cpu.ecol)
    p_cpu, ng_cpu = fof.fof3d(tpos, b, boxsize=box, min_size=20)
    p_gpu, ng_gpu = fof.fof3d(tpos.to(cuda), b, boxsize=box, min_size=20)
    assert ng_cpu == ng_gpu > 0 and torch.equal(p_gpu.cpu(), p_cpu)
    dm = torch.from_numpy(ptype == 1)
    args = (tpos[dm], torch.from_numpy(vel)[dm], p_cpu[dm].long(), tpos[~dm],
            torch.from_numpy(vel)[~dm])
    g_cpu = search_baryons(opt, *args, boxsize=box, vscale2=4.0e4)
    g_gpu = search_baryons(opt, *(a.to(cuda) for a in args), boxsize=box,
                           vscale2=4.0e4)
    assert torch.equal(g_gpu.cpu(), g_cpu) and bool((g_cpu > 0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("cores", [0, 2])
def test_cuda_substructure_path_matches_cpu(cuda, cores):
    """find_structures with the substructure search (and the merger-core
    search) on planted subhalos, on the card against the CPU: ids,
    hierarchy equal; the field and the level unbinds launch the
    potential; the leaf selection, grid and outliers on the card against
    the CPU."""
    from velociraptor_stf_tpu_torch import kernels
    from velociraptor_stf_tpu_torch.io.synthetic import (G_KMS,
                                                         planted_subhalos)
    from velociraptor_stf_tpu_torch.models import bgfield, localfield
    from velociraptor_stf_tpu_torch.models.pipeline import find_structures
    from velociraptor_stf_tpu_torch.utils import config as C

    pos, vel, mass, _ = planted_subhalos(3, seed=3, offset=4.0)
    opt = C.Options()
    opt.ellphys, opt.ellxscale, opt.ellhalophysfac = 0.2, 0.25, 4.0
    opt.fofbgtype = C.FOF3D
    opt.MinSize = opt.HaloMinSize = 20
    opt.iSubSearch, opt.iiterflag, opt.iHaloCoreSearch = 1, 1, cores
    opt.uinfo.unbindflag, opt.iBoundHalos, opt.G = 1, 2, G_KMS
    C.config_check(opt)
    want = find_structures(opt, pos, vel, mass, boxsize=16.0, device="cpu")
    kernels.reset_launches()
    got = find_structures(opt, pos, vel, mass, boxsize=16.0, device=cuda)
    assert got.ngroups == want.ngroups and (want.parent > 0).sum() >= 2
    np.testing.assert_array_equal(got.pfof, want.pfof)
    for k in ("parent", "hostid", "hierarchy_level"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert kernels.LAUNCHES["potential"] >= 3

    t = [torch.from_numpy(a) for a in (pos, vel, mass)]
    d_cpu, c_cpu, _ = localfield.velocity_density(t[0], t[1],
                                                  return_candidates=True)
    d_gpu, c_gpu, _ = localfield.velocity_density(
        t[0].to(cuda), t[1].to(cuda), return_candidates=True)
    assert torch.equal(c_gpu.cpu(), c_cpu)
    torch.testing.assert_close(d_gpu.cpu(), d_cpu, rtol=1e-4, atol=0)
    g_cpu = bgfield.background_grid(*t, 100)
    g_gpu = bgfield.background_grid(*(a.to(cuda) for a in t), 100)
    for a, b in zip(g_gpu, g_cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
