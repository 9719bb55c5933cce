"""Background velocity grid and phase-space outlier values (port of
velociraptor_stf_tpu/models/bgfield.py: ``background_grid``,
``_denv_ratio_dense``, ``_denv_ratio_bucketed``, ``denv_ratio``,
``_ratio_distribution``, ``_skewgauss_refine`` and ``outlier_values``;
the refinement is split into ``distribution``, ``refine`` and
``normalise`` so that one fit serves many batches).

* Grid (reference bgfield.cxx:21-197): equal-count cells of about
  ``cellsize`` particles from the KD median partition of the (pow2-padded)
  set, with each cell's mass-weighted centre, mean velocity and inverse
  velocity dispersion tensor.  ``gridtype`` 2 (PHASEENGRID) splits on
  phase coordinates with velocities scaled to the positional extent.
* R (reference GetDenVRatio, localbgcomp.cxx:14): per particle, Shepard
  weights over its MAXNGRID + 1 = 7 nearest cells interpolate the cell
  velocity and inverse dispersion, and R = log(rho_v / Nsearch) -
  log((2 pi)^-3/2 |S^-1|^1/2 exp(-dv S^-1 dv / 2)).  Dense (N, C)
  search, or the two-level KD-bucket search for large N x C.
* ell (reference DetermineDenVRatioDistribution + GetOutliersValues,
  localbgcomp.cxx:134,471): histogram R, take the mode and the two
  e^-1/2 crossings, refine with the skew-Gaussian Levenberg-Marquardt fit
  (8 parameter-freezing schedules x 30 steps) when the set has at least
  16 MINSUBSIZE members, and normalise ell = (R - mode) / sd.

Every function takes one set or a batch of B sets of one size (a leading
batch axis).  Histograms are sorted segment sums (no float atomics, so a
card gives the same bins on every run); the nearest cells keep the
reference's tie order (``ops/segments.py::smallest_k``).  The fit is tiny
and serial (4 parameters, at most 256 bins), so it runs on the host
(CPU tensors), batched over every set that takes one (the recursion
fits a whole level at once): on a card it would be some ten thousand
launches per call.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..ops import segments as seg
from ..ops.kdgrid import median_partition
from ..utils.config import MINSUBSIZE

MAXNGRID = 6  # reference allvars.h:185 (interpolation uses MAXNGRID+1 cells)

_BUCKET = 32      # cells per KD bucket
_NBOX = 4         # nearest buckets searched per particle
_PCHUNK = 1 << 16
_DENSE_MAX = 1 << 28   # n * C above which the bucketed search is taken


def _batched(x: torch.Tensor, nd: int) -> Tuple[torch.Tensor, bool]:
    """``x`` with a leading batch axis (added when it has ``nd`` dims)."""
    return (x[None], True) if x.dim() == nd else (x, False)


def grid_levels(npad: int, cellsize: int) -> int:
    """Depth of the median partition for ``npad`` rows and cells of about
    ``cellsize`` particles (reference ``_grid_levels``)."""
    levels = 0
    while (npad >> (levels + 1)) >= max(cellsize, 1):
        levels += 1
    return levels


def background_grid(pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor,
                    cellsize: int, gridtype: int = 1):
    """Equal-count background cells: (cellpos (C, 3), gvel (C, 3),
    gveldisp_inv (C, 3, 3), cell_ok (C,)), with a leading batch axis when
    the inputs have one.  Padding-only cells are parked far away."""
    pos, single = _batched(pos, 2)
    vel, _ = _batched(vel, 2)
    mass, _ = _batched(mass, 1)
    B, n = pos.shape[0], pos.shape[1]
    dev, dt = pos.device, pos.dtype
    npad = 1
    while npad < n:
        npad *= 2
    levels = grid_levels(npad, cellsize)
    C = 1 << levels
    chunk = npad // C
    lo, hi = pos.amin(1), pos.amax(1)                         # (B, 3)
    extent = torch.amax(hi - lo, -1)                          # (B,)
    extra = npad - n
    farpos = hi[:, None, :] + (extent + 1.0)[:, None, None] * \
        (2.0 + torch.arange(extra, dtype=dt, device=dev))[None, :, None]
    pos_ext = torch.cat([pos, farpos], 1)
    vel_ext = torch.cat([vel, vel.new_zeros(B, extra, 3)], 1)
    mass_ext = torch.cat([mass, mass.new_zeros(B, extra)], 1)
    if gridtype == 2:   # PHASEENGRID: split on scaled phase coordinates
        vext = torch.clamp_min(vel.amax(1) - vel.amin(1), 1e-30)
        xext = torch.clamp_min(hi - lo, 1e-30)
        scale = torch.amax(xext, -1) / torch.clamp_min(
            torch.amax(vext, -1), 1e-30)
        pad_idx = median_partition(
            torch.cat([pos_ext, vel_ext * scale[:, None, None]], -1), levels)
    else:
        pad_idx = median_partition(pos_ext, levels)
    row = torch.arange(B, device=dev)[:, None]
    valid = (pad_idx < n).view(B, C, chunk)
    P = pos_ext[row, pad_idx].view(B, C, chunk, 3)
    V = vel_ext[row, pad_idx].view(B, C, chunk, 3)
    M = torch.where(valid, mass_ext[row, pad_idx].view(B, C, chunk), 0.0)
    msum = M.sum(2)
    mtot = torch.clamp_min(msum, 1e-30)
    cell_ok = msum > 0
    cellpos = (P * M[..., None]).sum(2) / mtot[..., None]
    far = hi[:, None, :] + (extent + 1.0)[:, None, None] * \
        (2.0 + torch.arange(C, dtype=dt, device=dev))[None, :, None]
    cellpos = torch.where(cell_ok[..., None], cellpos, far)
    gvel = (V * M[..., None]).sum(2) / mtot[..., None]
    dv = V - gvel[:, :, None, :]
    disp = torch.einsum("bcki,bckj,bck->bcij", dv, dv, M) / \
        mtot[..., None, None]
    tr = torch.diagonal(disp, dim1=-2, dim2=-1).sum(-1) / 3.0
    disp = disp + (1e-8 * torch.clamp_min(tr, 1e-20))[..., None, None] * \
        torch.eye(3, dtype=dt, device=dev)
    disp_inv = torch.linalg.inv(disp)
    out = (cellpos, gvel, disp_inv, cell_ok)
    return tuple(o[0] for o in out) if single else out


def _ratio_from_neighbours(vel, density, gvel, gveldisp_inv, nn, d2nn,
                           nsearch: int):
    """R of each particle from its k nearest cells ``nn`` at squared
    distances ``d2nn`` (one set: (n,) rows)."""
    norm = (2.0 * math.pi) ** -1.5
    dist = torch.sqrt(d2nn + 1e-16)
    maxdist = torch.amax(dist, 1, keepdim=True)
    w = ((maxdist - dist) / (maxdist * dist)) ** 2
    wsum = torch.clamp_min(w.sum(1), 1e-30)
    vm = (gvel[nn] * w[..., None]).sum(1) / wsum[:, None]
    isv = (gveldisp_inv[nn] * w[..., None, None]).sum(1) / \
        wsum[:, None, None]
    sv = torch.sqrt(torch.abs(torch.linalg.det(isv)))
    vp = vel - vm
    vsv = torch.einsum("ni,nij,nj->n", vp, isv, vp)
    fbg = torch.log(torch.clamp_min(sv, 1e-30)) - 0.5 * vsv
    tempdenv = torch.clamp_min(density / nsearch, 1e-30)
    return torch.log(tempdenv) - math.log(norm) - fbg


def _denv_ratio_dense(pos, vel, density, cellpos, gvel, gveldisp_inv,
                      nsearch: int) -> torch.Tensor:
    """R from the dense (n, C) distances to every cell of one set."""
    k = min(MAXNGRID + 1, cellpos.shape[0])
    d2 = seg.sq3(pos[:, None, :] - cellpos[None, :, :])
    nn = seg.smallest_k(d2, k)
    return _ratio_from_neighbours(vel, density, gvel, gveldisp_inv, nn,
                                  d2.gather(1, nn), nsearch)


def _denv_ratio_bucketed(pos, vel, density, cellpos, gvel, gveldisp_inv,
                         nsearch: int) -> torch.Tensor:
    """R from a two-level 7-nearest search of one set: cells are KD
    leaves in partition order, so runs of ``_BUCKET`` cells are subtrees
    with compact boxes; each particle ranks the boxes by point-to-box
    distance and searches the cells of its ``_NBOX`` nearest exactly."""
    k = MAXNGRID + 1
    n, C = pos.shape[0], cellpos.shape[0]
    nb = C // _BUCKET
    boxes = cellpos.view(nb, _BUCKET, 3)
    blo, bhi = boxes.amin(1), boxes.amax(1)
    lane = torch.arange(_BUCKET, device=pos.device)
    out = torch.empty(n, dtype=pos.dtype, device=pos.device)
    for s in range(0, n, _PCHUNK):
        p = pos[s:s + _PCHUNK]
        d_lo = torch.clamp_min(blo[None] - p[:, None, :], 0.0)
        d_hi = torch.clamp_min(p[:, None, :] - bhi[None], 0.0)
        bb = seg.smallest_k(seg.sq3(d_lo + d_hi), _NBOX)
        cand = (bb[:, :, None] * _BUCKET + lane).reshape(p.shape[0], -1)
        d2 = seg.sq3(p[:, None, :] - cellpos[cand])
        sel = seg.smallest_k(d2, k)
        out[s:s + _PCHUNK] = _ratio_from_neighbours(
            vel[s:s + _PCHUNK], density[s:s + _PCHUNK], gvel, gveldisp_inv,
            cand.gather(1, sel), d2.gather(1, sel), nsearch)
    return out


def denv_ratio(pos, vel, density, cellpos, gvel, gveldisp_inv,
               nsearch: int) -> torch.Tensor:
    """(N,) R values (reference GetDenVRatio, localbgcomp.cxx:14), or
    (B, N) for a batch: dense for small grids, bucketed above
    n x C = 2^28 (the reference's switch)."""
    pos, single = _batched(pos, 2)
    vel, _ = _batched(vel, 2)
    density, _ = _batched(density, 1)
    cellpos, _ = _batched(cellpos, 2)
    gvel, _ = _batched(gvel, 2)
    gveldisp_inv, _ = _batched(gveldisp_inv, 3)
    n, C = pos.shape[1], cellpos.shape[1]
    fn = _denv_ratio_dense if (C <= 4 * _BUCKET or n * C <= _DENSE_MAX) \
        else _denv_ratio_bucketed
    R = torch.stack([fn(pos[b], vel[b], density[b], cellpos[b], gvel[b],
                        gveldisp_inv[b], nsearch)
                     for b in range(pos.shape[0])])
    return R[0] if single else R


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Row medians ignoring NaN, the mean of the two middle values for an
    even count, as ``jnp.nanmedian`` computes it (float32 weights)."""
    s = torch.sort(x, dim=-1).values            # NaN sorts last
    cnt = (~torch.isnan(x)).sum(-1).to(x.dtype)
    q = 0.5 * (cnt - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    top = torch.clamp_min(cnt - 1.0, 0.0)
    low = torch.minimum(torch.clamp_min(low, 0.0), top).long()
    high = torch.minimum(torch.clamp_min(high, 0.0), top).long()
    lv = s.gather(-1, low[..., None])[..., 0]
    hv = s.gather(-1, high[..., None])[..., 0]
    return lv * lw + hv * hw


def _histogram(R, w, lo, hi, nb: int):
    """Per-row histograms (B, nb) of R over [lo, hi) with weights ``w``
    (already zero outside the active rows), and the bin widths (B,)."""
    B, n = R.shape
    width = torch.clamp_min((hi - lo) / nb, 1e-12)
    ir = torch.clamp(((R - lo[:, None]) / width[:, None]).to(torch.int32),
                     0, nb).long()
    w = torch.where((R >= lo[:, None]) & (R < hi[:, None]), w, 0.0)
    flat = ir + (nb + 1) * torch.arange(B, device=R.device)[:, None]
    h = seg.segment_sum(w.reshape(-1), flat.reshape(-1), B * (nb + 1))
    return h.view(B, nb + 1)[:, :nb], width


def _ratio_distribution(R, mass, active, nbins: int, nbins2: int):
    """Mode and two-sided e^-1/2-crossing dispersions of each row of the
    (B, n) R values (reference DetermineDenVRatioDistribution,
    localbgcomp.cxx:134): a coarse histogram finds the peak, a second one
    over +-3 robust sigma about it refines the mode and the crossings."""
    inf = math.inf
    rmin = torch.where(active, R, inf).amin(1)
    rmax = torch.where(active, R, -inf).amax(1)
    w = torch.where(active, mass, 0.0)
    h0, w0 = _histogram(R, w, rmin, rmax, nbins)
    m0 = rmin + (torch.argmax(h0, 1) + 0.5) * w0
    nan = torch.tensor(math.nan, dtype=R.dtype, device=R.device)
    med = _nanmedian(torch.where(active, R, nan))
    sg = 1.4826 * _nanmedian(torch.where(active, torch.abs(R - med[:, None]),
                                         nan))
    sg = torch.clamp_min(sg, 1e-6)
    nb2 = nbins2
    lo2, hi2 = m0 - 3 * sg, m0 + 3 * sg
    h1, w1 = _histogram(R, w, lo2, hi2, nb2)
    ip = torch.argmax(h1, 1)
    peak = h1.gather(1, ip[:, None])[:, 0]
    mode = lo2 + (ip + 0.5) * w1
    thresh = math.exp(-0.5) * peak
    bins = torch.arange(nb2, device=R.device)[None, :]
    below = h1 <= thresh[:, None]

    def at(j):
        return h1.gather(1, j[:, None])[:, 0]

    jlo = torch.where(below & (bins <= ip[:, None]), bins, -1).amax(1)
    jl = torch.clamp(jlo, 0, nb2 - 2)
    frac = torch.clamp((thresh - at(jl)) /
                       torch.clamp_min(at(jl + 1) - at(jl), 1e-30), 0.0, 1.0)
    xlo = lo2 + (jl + 0.5 + frac) * w1
    sdlow = torch.where(jlo >= 0, mode - xlo, sg)

    jhi = torch.where(below & (bins >= ip[:, None]), bins, nb2).amin(1)
    jh = torch.clamp(jhi, 1, nb2 - 1)
    frac = torch.clamp((thresh - at(jh - 1)) /
                       torch.clamp_min(at(jh) - at(jh - 1), -1e-30), 0.0, 1.0)
    xhi = lo2 + (jh - 0.5 + frac) * w1
    sdhigh = torch.where(jhi < nb2, xhi - mode, sg)
    return mode, torch.clamp_min(sdlow, 1e-6), torch.clamp_min(sdhigh, 1e-6)


# parameter-freezing schedules of the reference's skew-Gaussian fit
# (localbgcomp.cxx:424-433): 1 = frozen, 0 = free; columns (A, mu, var, s2)
_SKEW_FIX = np.array([
    [1, 1, 0, 1],
    [1, 0, 0, 1],
    [0, 0, 0, 1],
    [1, 1, 1, 0],
    [0, 1, 1, 1],
    [1, 0, 0, 1],
    [1, 0, 0, 0],
    [0, 0, 0, 0],
], np.float32)


def _skew_model(p, xbin):
    """Skew-Gaussian model (S, nb) and its Jacobian (S, nb, 4) at
    parameters p (S, 4) = (A, mu, var, s2) (reference stf-fitting.h:11-48:
    sd var*s2 below the mean, var above)."""
    A, mu = p[:, 0:1], p[:, 1:2]
    var = torch.clamp_min(p[:, 2:3], 1e-12)
    s2 = torch.clamp_min(p[:, 3:4], 1e-12)
    dx = xbin - mu
    below = xbin <= mu
    e_lo = torch.exp(-0.5 * dx * dx / (var * s2))
    e_hi = torch.exp(-0.5 * dx * dx / var)
    e = torch.where(below, e_lo, e_hi)
    dmu = torch.where(below, A * e_lo * dx / (var * s2), A * e_hi * dx / var)
    dvar = torch.where(below, A * e_lo * dx * dx / (var * var * s2) * 0.5,
                       A * e_hi * dx * dx / (var * var) * 0.5)
    ds2 = torch.where(below, A * e_lo * dx * dx / (var * s2 * s2) * 0.5,
                      0.0)
    return A * e, torch.stack([e, dmu, dvar, ds2], -1)


def _valid_fit(p, c):
    return torch.isfinite(p).all(-1) & (p[:, 2] > 0) & (p[:, 3] > 0) & \
        torch.isfinite(c)


def _skewgauss_fit(rbin, Wd, xbin, mode, sdhigh):
    """Weighted nonlinear least squares of the skew Gaussian to (S, nb)
    histograms (reference FitNonLinLS, localbgcomp.cxx:399-460): each
    schedule runs 30 Levenberg-Marquardt steps from the best parameters
    so far and wins when its chi^2 is lower.  Returns (S, 4)."""
    dt = rbin.dtype

    def chi2_of(p):
        r = rbin - _skew_model(p, xbin)[0]
        return (Wd * r * r).sum(-1)

    S = rbin.shape[0]
    p = torch.stack([rbin.amax(-1), mode, sdhigh * sdhigh * 0.8,
                     torch.ones(S, dtype=dt)], -1)
    best_c = chi2_of(p)
    for fix in torch.from_numpy(_SKEW_FIX):
        free = 1.0 - fix
        fmask = free[:, None] * free[None, :]
        fdiag = torch.diag(fix)
        q, c_cur = p, best_c
        lam = torch.full((S,), 1e-2, dtype=dt)
        for _ in range(30):
            m, J = _skew_model(q, xbin)
            r = rbin - m
            JW = J * Wd[..., None]
            H = JW.transpose(1, 2) @ J
            g = (JW.transpose(1, 2) @ r[..., None])[..., 0]
            dg = torch.clamp_min(torch.diagonal(H, dim1=1, dim2=2), 1e-12)
            H = H + lam[:, None, None] * torch.diag_embed(dg)
            H = H * fmask + fdiag
            step = torch.linalg.solve_ex(H, (g * free)[..., None])[0][..., 0]
            q_new = q + step
            c_new = chi2_of(q_new)
            accept = _valid_fit(q_new, c_new) & (c_new < c_cur)
            q = torch.where(accept[:, None], q_new, q)
            c_cur = torch.where(accept, c_new, c_cur)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                              1e-8, 1e8)
        ok = _valid_fit(q, c_cur) & (c_cur < best_c)
        p = torch.where(ok[:, None], q, p)
        best_c = torch.where(ok, c_cur, best_c)
    return p


def _fit_window(R, mass, active, mode, sdlow, sdhigh, nbins: int):
    """The fit's input per row: the mass histogram over mode - 4 sdlow ..
    mode + 4 sdhigh, its weights (inverse summed squared masses; empty
    bins take the smallest) and the bin centres, each (B, nbins)."""
    lo = mode - 4.0 * sdlow
    hi = mode + 4.0 * sdhigh
    w = torch.where(active, mass, 0.0)
    rbin, width = _histogram(R, w, lo, hi, nbins)
    w2, _ = _histogram(R, w * w, lo, hi, nbins)
    minw2 = torch.where(rbin > 0, w2, math.inf).amin(1)
    minw2 = torch.where(torch.isfinite(minw2), minw2, 1.0)
    Wd = torch.where(rbin > 0, 1.0 / torch.clamp_min(w2, 1e-30),
                     1.0 / minw2[:, None])
    xbin = lo[:, None] + (torch.arange(nbins, dtype=R.dtype,
                                       device=R.device) + 0.5) * \
        width[:, None]
    return rbin, Wd, xbin


def distribution(R, mass, active, skewfit: bool = True) -> list:
    """[mode, sdlow, sdhigh, fit] of each row of the (B, n) R values: the
    histogram estimates and, when some row has the reference's 16
    MINSUBSIZE members for the skew-Gaussian refinement
    (localbgcomp.cxx:397), fit = (those rows, their fit window); the bin
    counts follow n, padding included, as the reference's do."""
    n = R.shape[1]
    nbins = int(math.ceil(math.log2(max(n, 2)) + 1) * 4)
    nbins2 = int(min(max(2 * n ** (1 / 3), 16), 256))
    mode, sdlow, sdhigh = _ratio_distribution(R, mass, active, nbins, nbins2)
    fit = None
    if skewfit:
        enough = active.sum(1) >= 16 * MINSUBSIZE
        if bool(enough.any()):
            fit = (enough,) + _fit_window(R, mass, active, mode, sdlow,
                                          sdhigh, nbins2)
    return [mode, sdlow, sdhigh, fit]


def refine(dists: list) -> None:
    """The skew-Gaussian refinement of every row with a fit window in
    ``dists`` (``distribution``'s lists), in one host fit: the windows
    are padded with zero-weight bins to the widest, which changes no sum
    of the fit.  Updates mode, sdlow and sdhigh in place."""
    todo = [d for d in dists if d[3] is not None]
    if not todo:
        return
    nb = max(d[3][1].shape[1] for d in todo)

    def widen(x, fill):
        return torch.cat([x, fill.expand(x.shape[0], nb - x.shape[1])], 1)

    cols = [torch.cat(c).cpu() for c in zip(*[
        (widen(rbin[sel], rbin.new_zeros(1, 1)),
         widen(Wd[sel], Wd.new_zeros(1, 1)),
         widen(xbin[sel], xbin[sel][:, -1:]), d[0][sel], d[2][sel])
        for d in todo for sel, rbin, Wd, xbin in [d[3]]])]
    p = _skewgauss_fit(*cols)
    var = torch.clamp_min(p[:, 2], 1e-12)
    s2 = torch.clamp_min(p[:, 3], 1e-12)
    fitted = torch.stack([p[:, 1], torch.sqrt(var * s2), torch.sqrt(var)])
    off = 0
    for d in todo:
        sel = d[3][0]
        k = int(sel.sum())
        got = fitted[:, off:off + k].to(d[0].device)
        off += k
        for j in range(3):
            d[j] = d[j].clone()
            d[j][sel] = got[j]
        d[3] = None


def normalise(R, mode, sdlow, sdhigh) -> torch.Tensor:
    """ell = (R - mode) / sdhigh above the mode, / sdlow below."""
    d = R - mode[:, None]
    return torch.where(d > 0, d / sdhigh[:, None], d / sdlow[:, None])


def outlier_values(R, mass, active=None, skewfit: bool = True):
    """Normalised outlier values (reference GetOutliersValues,
    localbgcomp.cxx:471): (ell, (mode, sdlow, sdhigh)), for one set or a
    (B, n) batch."""
    R, single = _batched(R, 1)
    mass, _ = _batched(mass, 1)
    if active is None:
        active = torch.ones_like(R, dtype=torch.bool)
    active, _ = _batched(active, 1)
    dist = distribution(R, mass, active, skewfit)
    refine([dist])
    stats = tuple(dist[:3])
    ell = normalise(R, *stats)
    if single:
        return ell[0], tuple(s[0] for s in stats)
    return ell, stats
