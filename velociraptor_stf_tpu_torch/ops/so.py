"""Spherical overdensities from all particles (port of
velociraptor_stf_tpu/ops/so.py: ``point_windows_dense``, the flat (row,
col) candidate expansion of ``ops/fof.py::flat_candidates``,
``_class_histogram``, ``_so_crossings``, ``so_masses_all_particles``,
``so_search_radii`` and ``so_particle_list``).

For every field halo, every particle (tagged or not) within its search
radius enters a per-(halo, log-radius bin) mass and count histogram; the
enclosed density at the bin edges gives the first inside-out crossing of
each threshold with the reference's log-log interpolation (reference
GetSOMasses, substructureproperties.cxx:2731, and
CalculateSphericalOverdensity, :5203).  Halos are grouped in octave
classes of search radius, each with a cell grid at least its largest
radius wide, so the 27 cells around a halo's cell hold its whole ball.

Where the reference sizes one padded candidate table per class, the port
counts each class's candidates exactly and expands and bins them in
chunks of at most ``_slot_budget`` slots, in the reference's slot order
(halo, window, particle).  The window starts are binary searches into the
cell-sorted ids instead of a dense per-cell table.  Histogram masses are
sorted segment sums and counts are ``bincount``s: no float atomics, so
two runs on a card give the same masses.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from . import segments as seg
from .cells import CellGrid, bin_particles, build_grid, cell_coords

_LN_3_4PI = math.log(3.0 / (4.0 * math.pi))
_GRID_CELLS = 2**31 - 1     # the reference's cap (int32 cell ids)
# the 9 (dx, dy) columns of the 27-cell stencil, in the reference's order
_OFFSETS_XY = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]


def _slot_budget(device: torch.device) -> int:
    """Candidate slots per chunk: each holds a row, a column and a
    gathered position (~40 bytes with temporaries), so ~1.3 GB on a card
    and ~40 MB on the host."""
    return (1 << 25) if device.type == "cuda" else (1 << 20)


def point_windows_dense(qcoords: torch.Tensor, cid_sorted: torch.Tensor,
                        grid: CellGrid, periodic: bool, clip_x: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, 18) start and count of the candidate windows of the 27-cell
    stencil around query cells: 9 (dx, dy) columns, each a contiguous
    z-run of the cell-sorted particles, then 9 single-cell periodic z-wrap
    remainders.  ``clip_x``: a periodic grid that does not wrap in x (a
    slab with its ghost columns, ``parallel/distributed_fof.py``)."""
    nx, ny, nz = grid.ncells

    def pstart(c):      # particles in cells below c
        return torch.searchsorted(cid_sorted, c)

    x, y, z = qcoords[:, 0], qcoords[:, 1], qcoords[:, 2]
    zero = torch.zeros_like(x)
    if periodic and nz >= 3:
        zlo = torch.where(z == 0, 0, z - 1)
        zhi = torch.where(z == nz - 1, nz - 1, z + 1)
        wrap = (z == 0) | (z == nz - 1)
        zb = torch.where(z == 0, nz - 1, zero)
    elif periodic:
        zlo, zhi = zero, torch.full_like(z, nz - 1)
        wrap = torch.zeros_like(x, dtype=torch.bool)
        zb = zero
    else:
        zlo = torch.clamp_min(z - 1, 0)
        zhi = torch.clamp_max(z + 1, nz - 1)
        wrap = torch.zeros_like(x, dtype=torch.bool)
        zb = zero

    psts, pcns, bsts, bcns = [], [], [], []
    for dx, dy in _OFFSETS_XY:
        if periodic:
            xq = torch.remainder(x + dx, nx)
            yq = torch.remainder(y + dy, ny)
            ok = None
            if clip_x:
                ok = (x + dx >= 0) & (x + dx < nx)
                xq = torch.clamp(x + dx, 0, nx - 1)
        else:
            xq, yq = x + dx, y + dy
            ok = (xq >= 0) & (xq < nx) & (yq >= 0) & (yq < ny)
            xq = torch.clamp(xq, 0, nx - 1)
            yq = torch.clamp(yq, 0, ny - 1)
        base = (xq * ny + yq) * nz
        s = pstart(base + zlo)
        cnt = pstart(base + zhi + 1) - s
        sb = pstart(base + zb)
        cb = torch.where(wrap, pstart(base + zb + 1) - sb, 0)
        if ok is not None:
            cnt = torch.where(ok, cnt, 0)
            cb = torch.where(ok, cb, 0)
        psts.append(s)
        pcns.append(cnt)
        bsts.append(sb)
        bcns.append(cb)
    return torch.stack(psts + bsts, 1), torch.stack(pcns + bcns, 1)


def flat_candidates(pst: torch.Tensor, pcn: torch.Tensor,
                    budget: int) -> Iterator[Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """Expand per-row windows into (row, col) candidate slots, in order
    (row, window, column), yielding chunks of whole windows of at most
    ``budget`` slots (a longer window is a chunk of its own)."""
    nwin = pst.shape[1]
    start = pst.reshape(-1)
    length = pcn.reshape(-1)
    csum = torch.cumsum(length, 0)
    ends = csum.tolist() if csum.numel() else []
    s0, base = 0, 0
    while s0 < len(ends):
        # the last window that keeps this chunk within the budget
        s1 = int(np.searchsorted(ends, base + budget, side="right"))
        s1 = max(s1, s0 + 1)
        total = ends[s1 - 1] - base
        if total > 0:
            # each slot's window by binary search over the chunk's window
            # ends: balanced work however long the windows are
            ends_c = csum[s0:s1] - base
            t = torch.arange(total, device=pst.device)
            k = torch.searchsorted(ends_c, t, right=True)
            first = ends_c - length[s0:s1]
            yield (s0 + k) // nwin, start[s0 + k] + (t - first[k])
        base = ends[s1 - 1]
        s0 = s1


def _offsets(pos_s, centers, row, col,
             boxsize: Optional[float]) -> torch.Tensor:
    """Candidate minus centre, the minimum image in a periodic box
    (rounding half to even, as ``jnp.round``)."""
    d = pos_s[col] - centers[row]
    if boxsize:
        d = d - boxsize * torch.round(d / boxsize)
    return d


def _class_histogram(pos_s, mass_s, centers, rsearch, cid_sorted,
                     grid: CellGrid, boxsize: Optional[float], nbins: int,
                     lnumin: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, nbins) mass and count histograms of one radius class.  Bin 0
    holds r <= umin * rsearch; bins 1..nbins-1 are log-spaced in u =
    r / rsearch over [umin, 1].  Masses are summed in float64 (exact for
    equal masses), so the sum does not depend on how the candidates are
    split: a mesh adds its shards' histograms
    (``parallel/distributed_so.py``); the caller rounds them to the
    positions' dtype."""
    H = centers.shape[0]
    periodic = bool(boxsize)
    pst, pcn = point_windows_dense(cell_coords(centers, grid, periodic),
                                   cid_sorted, grid, periodic)
    dlog = -lnumin / (nbins - 1)
    Mh = torch.zeros(H * nbins, dtype=torch.float64, device=pos_s.device)
    Nh = torch.zeros(H * nbins, dtype=torch.int64, device=pos_s.device)
    for row, col in flat_candidates(pst, pcn, _slot_budget(pos_s.device)):
        u = torch.sqrt(seg.sq3(_offsets(pos_s, centers, row, col,
                                        boxsize))) / \
            torch.clamp_min(rsearch[row], 1e-30)
        mcand = mass_s[col]
        # zero-mass slots never count (the reference's padding guard)
        ok = (u <= 1.0) & (mcand > 0)
        b = 1 + torch.floor((torch.log(torch.clamp_min(u, 1e-30)) - lnumin)
                            / dlog).long()
        flat = (row * nbins + torch.clamp(b, 0, nbins - 1))[ok]
        Mh += seg.segment_sum(mcand[ok].double(), flat, H * nbins)
        Nh += torch.bincount(flat, minlength=H * nbins)
    return Mh.view(H, nbins), Nh.view(H, nbins)


def _so_crossings(Mh, Nh, rsearch, lnthr, minnum, first_mass, nbins: int,
                  lnumin: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inside-out first crossing of each ln-density threshold on the binned
    enclosed-density profile, with the reference's log-log interpolation;
    (M, R) each (H, nthr), 0 where not found or below one particle mass
    (reference :5302-5308)."""
    H = Mh.shape[0]
    Mc = torch.cumsum(Mh, 1)
    Nc = torch.cumsum(Nh, 1)
    dlog = -lnumin / (nbins - 1)
    lnu_edge = torch.cat([
        torch.tensor([lnumin], dtype=Mh.dtype, device=Mh.device),
        lnumin + dlog * torch.arange(1, nbins, dtype=Mh.dtype,
                                     device=Mh.device)])
    redge = rsearch[:, None] * torch.exp(lnu_edge)[None, :]
    lnrho = torch.log(torch.clamp_min(Mc, 1e-30)) - 3.0 * torch.log(
        torch.clamp_min(redge, 1e-30)) + _LN_3_4PI
    usable = (Nc >= minnum[:, None]) & (Mc > 0)
    cols = torch.arange(nbins, device=Mh.device)
    rows = torch.arange(H, device=Mh.device)
    Ms, Rs = [], []
    for t in range(lnthr.shape[0]):
        thr = lnthr[t]
        below = usable & (lnrho < thr)
        k = torch.where(below, cols[None, :], nbins).amin(1)
        found = k < nbins
        kc = torch.clamp_max(k, nbins - 1)
        kp = torch.clamp_min(kc - 1, 0)
        rho_k, rho_p = lnrho[rows, kc], lnrho[rows, kp]
        drho = rho_k - rho_p
        safe = torch.abs(drho) > 1e-12
        gamma1 = torch.where(safe, (lnu_edge[kc] - lnu_edge[kp]) / drho, 0.0)
        gamma2 = torch.where(safe, torch.log(
            Mc[rows, kc] / torch.clamp_min(Mc[rows, kp], 1e-30)) / drho, 0.0)
        delta = thr - rho_k
        R = redge[rows, kc] * torch.exp(gamma1 * delta)
        M = Mc[rows, kc] * torch.exp(gamma2 * delta)
        bad = ~found | (M < first_mass)
        Ms.append(torch.where(bad, 0.0, M))
        Rs.append(torch.where(bad, 0.0, R))
    return torch.stack(Ms, 1), torch.stack(Rs, 1)


def _grid_bounds(pos: torch.Tensor, boxsize: Optional[float]):
    if boxsize:
        return np.zeros(3), np.full(3, boxsize)
    return pos.amin(0).cpu().numpy(), pos.amax(0).cpu().numpy()


def so_masses_all_particles(pos: torch.Tensor, mass: torch.Tensor,
                            centers, rsearch, lnrho_thresholds,
                            boxsize: Optional[float] = None,
                            nbins: int = 128, umin: float = 3e-3,
                            minnum=None, first_mass=None
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """SO masses and radii from all particles for H halos: ``centers``
    (H, 3), ``rsearch`` (H,), ``lnrho_thresholds`` (nthr,) ln densities;
    returns (M, R) float64 numpy arrays of shape (H, nthr)."""
    centers = np.asarray(centers)
    rsearch = np.asarray(rsearch, np.float64)
    H = centers.shape[0]
    nthr = len(lnrho_thresholds)
    dev = pos.device
    lnthr = torch.tensor(np.asarray(lnrho_thresholds, np.float64),
                         dtype=pos.dtype, device=dev)
    minnum = np.full(H, 1, np.int64) if minnum is None else \
        np.asarray(minnum)
    first_mass = np.zeros(H) if first_mass is None else \
        np.asarray(first_mass)
    M_out = np.zeros((H, nthr), np.float64)
    R_out = np.zeros((H, nthr), np.float64)
    if H == 0:
        return M_out, R_out
    glo, ghi = _grid_bounds(pos, boxsize)
    # octave classes by search radius
    rs_max = float(rsearch.max())
    cls_of = np.maximum(0, np.ceil(np.log2(np.maximum(
        rs_max / np.maximum(rsearch, 1e-30), 1.0))).astype(int))
    lnumin = float(math.log(umin))
    for c in np.unique(cls_of):
        sel = np.where(cls_of == c)[0]
        grid = build_grid(glo, ghi, rs_max / (1 << int(c)),
                          periodic=bool(boxsize), boxsize=boxsize or 0.0,
                          max_total_cells=_GRID_CELLS)
        order, cid_sorted = bin_particles(pos, grid, bool(boxsize))
        rs = torch.tensor(rsearch[sel], dtype=pos.dtype, device=dev)
        Mh, Nh = _class_histogram(
            pos[order], mass[order],
            torch.tensor(centers[sel], dtype=pos.dtype, device=dev), rs,
            cid_sorted, grid, boxsize, nbins, lnumin)
        M, R = _so_crossings(
            Mh.to(pos.dtype), Nh, rs, lnthr,
            torch.tensor(minnum[sel], dtype=torch.int64, device=dev),
            torch.tensor(first_mass[sel], dtype=pos.dtype, device=dev),
            nbins, lnumin)
        M_out[sel] = M.double().cpu().numpy()
        R_out[sel] = R.double().cpu().numpy()
    return M_out, R_out


def so_search_radii(gmass, gsize, min_lnrho, search_fac: float
                    ) -> np.ndarray:
    """Per-halo SO search radius (reference substructureproperties.cxx:
    2820-2826): gsize * SphericalOverdensitySeachFac * radfac, radfac
    inflating the radius while the group's own mean density still exceeds
    the lowest threshold / 2."""
    gmass = np.asarray(gmass, np.float64)
    gsize = np.maximum(np.asarray(gsize, np.float64), 1e-30)
    fac = -math.log(4.0 * math.pi / 3.0) - min_lnrho
    radfac = np.maximum(1.0, np.exp((np.log(np.maximum(gmass, 1e-30))
                                     - 3.0 * np.log(gsize) + fac) / 3.0))
    return gsize * search_fac * radfac


def so_particle_list(pos: torch.Tensor, centers, rmax,
                     boxsize: Optional[float] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Indices of the particles within ``rmax`` of each centre, radius
    sorted per halo (``.catalog_SOlist``, reference io.cxx:1157), as CSR
    (offsets (H+1,), original particle indices)."""
    centers = np.asarray(centers)
    rmax = np.asarray(rmax, np.float64)
    H = centers.shape[0]
    if H == 0:
        return np.zeros(1, np.int64), np.zeros(0, np.int64)
    glo, ghi = _grid_bounds(pos, boxsize)
    grid = build_grid(glo, ghi, float(max(rmax.max(), 1e-30)),
                      periodic=bool(boxsize), boxsize=boxsize or 0.0,
                      max_total_cells=_GRID_CELLS)
    periodic = bool(boxsize)
    order, cid_sorted = bin_particles(pos, grid, periodic)
    pos_s = pos[order]
    ctr = torch.tensor(centers, dtype=pos.dtype, device=pos.device)
    rm = torch.tensor(rmax, dtype=pos.dtype, device=pos.device)
    pst, pcn = point_windows_dense(cell_coords(ctr, grid, periodic),
                                   cid_sorted, grid, periodic)
    rows, cols, rads = [], [], []
    for row, col in flat_candidates(pst, pcn, _slot_budget(pos.device)):
        r = torch.sqrt(seg.sq3(_offsets(pos_s, ctr, row, col, boxsize)))
        ok = r <= rm[row]
        rows.append(row[ok].cpu())
        cols.append(col[ok].cpu())
        rads.append(r[ok].cpu())
    row_np = torch.cat(rows).numpy() if rows else np.zeros(0, np.int64)
    col_np = torch.cat(cols).numpy() if cols else np.zeros(0, np.int64)
    r_np = torch.cat(rads).numpy() if rads else np.zeros(0, np.float32)
    perm = np.lexsort((r_np, row_np))
    orig = order.cpu().numpy()[col_np[perm]]
    offsets = np.zeros(H + 1, np.int64)
    np.add.at(offsets, row_np + 1, 1)
    return np.cumsum(offsets), orig.astype(np.int64)
