"""Float64 NumPy oracles for the reference's contested numerics.

The port's copy of ``velociraptor_stf_tpu/validation/oracles.py``,
holding the oracles that ``chip_smoke.py`` holds the port to (SO,
unbinding, velocity scales, the 3D and 6D FOF partitions, renumbering
and the periodic unwrap) and the substructure search's outlier fit and
core growth, so that the port imports nothing of the JAX package.

The reference cannot be built here (NBodylib absent), so these sequential
double-precision reimplementations of the three numerically delicate
algorithms serve as the validation targets for the f32 pipelines:

* ``so_oracle`` — spherical-overdensity log-log crossing interpolation
  (reference substructureproperties.cxx:5203-5308
  ``CalculateSphericalOverdensity``);
* ``unbind_oracle`` — the per-group sequential ejection loop
  (reference unbind.cxx:732-1199 ``Unbind`` +
  ``FillUnboundArrays``:63-100);
* ``vscale_oracle`` — the 6DFOF velocity scales
  (reference search.cxx:443-499), including the verbatim
  ``mtotregion`` accumulation bug of the uniform-scale branch for
  catalog-compatibility checks.

These are *independent reimplementations from the algorithm*, kept
deliberately scalar/sequential so they share no code path with the
vectorised implementations they validate.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np


def so_oracle(radii: np.ndarray, masses: np.ndarray,
              lgrhovals: Sequence[float],
              minnum: int) -> Tuple[np.ndarray, np.ndarray]:
    """(R, M) per log-density threshold for ONE group's member radii.

    ``radii``/``masses``: the group's particle radii about the chosen
    centre and masses (any order).  ``lgrhovals``: ln(rho) thresholds
    (e.g. ln(200 * rhocrit)).  ``minnum``: first particle index from
    which crossings are searched (reference ``minnum``).
    Mirrors CalculateSphericalOverdensity's walk: enclosed ln-density
    after each particle, log-log slope interpolation to the crossing,
    skipping non-decreasing-density steps; masses below the smallest
    particle mass zero out.
    """
    order = np.argsort(radii, kind="stable")
    r = np.asarray(radii, np.float64)[order]
    m = np.asarray(masses, np.float64)[order]
    n = len(r)
    nth = len(lgrhovals)
    R = np.zeros(nth)
    M = np.zeros(nth)
    if n == 0:
        return R, M
    fac = -math.log(4.0 * math.pi / 3.0)
    minnum = max(1, min(minnum, n))
    enc = float(np.sum(m[:minnum]))
    minmass = float(m[0])
    rc2 = max(float(r[minnum - 1]), 1e-300)
    enc2 = enc
    rho2 = math.log(enc2) - 3.0 * math.log(rc2) + fac
    found = np.zeros(nth, bool)
    for j in range(minnum, n):
        rc = max(float(r[j]), 1e-300)
        enc += float(m[j])
        rho = math.log(enc) - 3.0 * math.log(rc) + fac
        drho = rho - rho2
        if drho == 0.0:
            continue
        gamma1 = math.log(rc / rc2) / drho
        gamma2 = math.log(enc / enc2) / drho
        if gamma1 > 0:
            # density not decreasing: skip without interpolating
            rho2, rc2, enc2 = rho, rc, enc
            continue
        for t in range(nth):
            if not found[t] and rho < lgrhovals[t]:
                delta = lgrhovals[t] - rho
                R[t] = rc * math.exp(gamma1 * delta)
                M[t] = enc * math.exp(gamma2 * delta)
                found[t] = True
        if found.all():
            break
        rho2, rc2, enc2 = rho, rc, enc
    for t in range(nth):
        if M[t] < minmass:
            M[t] = R[t] = 0.0
    return R, M


def unbind_oracle(pos: np.ndarray, vel: np.ndarray, mass: np.ndarray,
                  eps: float, G: float, Eratio: float = 1.0,
                  maxunbindfrac: float = 0.05, min_size: int = 20,
                  bgpot: int = 1, max_iters: int = 1000) -> np.ndarray:
    """Bound mask for ONE group, reference-sequential in float64.

    Mirrors the per-group Unbind loop (unbind.cxx:1100-1199, UPART
    semantics): exact direct-sum potential with Plummer softening;
    kinetic frame = CM velocity of the current members, updated
    incrementally as particles are removed; per iteration at most
    ``maxunbindfrac * ning`` particles (the least bound first, only while
    E > 0) are ejected; with ``bgpot == 0`` ejected particles' potential
    contributions are removed; the group dissolves below ``min_size``.
    """
    pos = np.asarray(pos, np.float64)
    vel = np.asarray(vel, np.float64)
    m = np.asarray(mass, np.float64)
    n = len(m)
    eps2 = float(eps) * float(eps)
    alive = np.ones(n, bool)

    # pairwise potential energies W_i = -G m_i sum_j m_j / sqrt(d^2+eps^2)
    d2 = np.sum((pos[:, None, :] - pos[None, :, :]) ** 2, -1) + eps2
    np.fill_diagonal(d2, np.inf)
    inv = 1.0 / np.sqrt(d2)
    W = -G * m * (inv @ m)

    for _ in range(max_iters):
        idx = np.nonzero(alive)[0]
        ning = len(idx)
        if ning < min_size:
            alive[:] = False
            break
        mtot = float(np.sum(m[idx]))
        cmvel = np.sum(vel[idx] * m[idx, None], 0) / mtot
        dv = vel[idx] - cmvel
        T = 0.5 * m[idx] * np.sum(dv * dv, -1)
        E = Eratio * T + W[idx]
        if np.max(E) <= 0:
            break
        pqsize = max(int(maxunbindfrac * ning), 1)
        order = np.argsort(-E, kind="stable")      # least bound first
        remove = [idx[j] for j in order[:pqsize] if E[j] > 0]
        if not remove:
            break
        alive[remove] = False
        if bgpot == 0:
            rest = np.nonzero(alive)[0]
            for k in remove:
                W[rest] += G * m[rest] * m[k] * inv[rest, k]
    return alive


def vscale_oracle(vel: np.ndarray, mass: np.ndarray, pfof: np.ndarray,
                  ngroups: int, ellhalo6dvfac: float,
                  adaptive: bool = True,
                  reproduce_reference_bug: bool = False) -> np.ndarray:
    """(ngroups+1,) 6DFOF velocity scales sigma_v^2 * fac^2 in float64.

    ``adaptive``: per-group dispersions (FOF6DADAPTIVE,
    search.cxx:472-499).  Otherwise the uniform scale from the largest
    group (search.cxx:443-463); with ``reproduce_reference_bug`` the
    verbatim stray-statement accumulation is reproduced — ``mtotregion``
    picks up ONLY the particle one past the largest group (the first
    member of the next group in sorted order), search.cxx:450.
    """
    vel = np.asarray(vel, np.float64)
    m = np.asarray(mass, np.float64)
    pfof = np.asarray(pfof)
    fac2 = float(ellhalo6dvfac) ** 2
    out = np.zeros(ngroups + 1)
    if adaptive:
        for g in range(1, ngroups + 1):
            sel = pfof == g
            if not sel.any():
                continue
            mt = np.sum(m[sel])
            vm = np.sum(vel[sel] * m[sel, None], 0) / mt
            out[g] = np.sum(np.sum((vel[sel] - vm) ** 2, -1) * m[sel]) \
                / mt * fac2
        return out
    sel = pfof == 1
    if not sel.any():
        return out
    sv = np.sum(vel[sel] * m[sel, None], 0)          # Sigma m v
    if reproduce_reference_bug:
        # sorted order: group 1 first, then group 2, ...; the stray
        # mtotregion statement runs once with i == iend = |group 1|
        nxt = pfof == 2
        if nxt.any():
            mtot = float(m[np.nonzero(nxt)[0][0]])
        elif (pfof == 0).any():
            mtot = float(m[np.nonzero(pfof == 0)[0][0]])
        else:
            mtot = float(m[np.nonzero(sel)[0][-1]])
    else:
        mtot = float(np.sum(m[sel]))
    vm = sv / mtot
    out[1:] = np.sum(np.sum((vel[sel] - vm) ** 2, -1) * m[sel]) \
        / mtot * fac2
    return out


def _union_find(n: int, pairs: np.ndarray) -> np.ndarray:
    """Root label per element from an (npairs, 2) edge list — plain
    sequential union-find with path halving (shares nothing with the
    pipeline's min-label fixed point)."""
    parent = np.arange(n, dtype=np.int64)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for a, b in pairs:
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    return np.fromiter((find(i) for i in range(n)), np.int64, n)


def renumber_by_size_oracle(labels: np.ndarray, min_size: int,
                            tiebreak: str = "minindex"
                            ) -> Tuple[np.ndarray, int]:
    """(pfof, ngroups): ids 1..ng by decreasing member count; groups below
    ``min_size`` get 0.  ``tiebreak``: equal-size groups are ordered by
    smallest original member index ("minindex", the FOF renumber) or by
    ascending input label ("label", the post-unbind renumber)."""
    labels = np.asarray(labels)
    n = len(labels)
    roots, inv, counts = np.unique(labels, return_inverse=True,
                                   return_counts=True)
    first = np.full(len(roots), n, np.int64)
    np.minimum.at(first, inv, np.arange(n))
    key = first if tiebreak == "minindex" else roots
    order = np.lexsort((key, -counts))
    eligible = counts[order] >= min_size
    ng = int(eligible.sum())
    gid = np.zeros(len(roots), np.int64)
    gid[order[eligible]] = np.arange(1, ng + 1)
    return gid[inv], ng


def fof3d_partition_oracle(pos: np.ndarray, b: float, boxsize: float,
                           min_size: int) -> Tuple[np.ndarray, int]:
    """3DFOF partition via scipy cKDTree pair query + union-find, float64,
    periodic.  Independent of the pipeline's cell-list / Pallas machinery
    (reference method: NBodylib KDTree::FOF, used at
    reference search.cxx:110)."""
    from scipy.spatial import cKDTree

    pos = np.asarray(pos, np.float64)
    tree = cKDTree(pos, boxsize=boxsize)
    pairs = tree.query_pairs(float(b), output_type="ndarray")
    roots = _union_find(len(pos), pairs)
    return renumber_by_size_oracle(roots, min_size)


def fof6d_partition_oracle(pos: np.ndarray, vel: np.ndarray,
                           pfof3: np.ndarray, ell6d: float,
                           vscale2: float, boxsize: float,
                           min_size: int) -> Tuple[np.ndarray, int]:
    """6DFOF refinement partition: brute-force O(ng^2) float64 pair test
    ``dx^2/ell6d^2 + dv^2/vscale2 <= 1`` per 3DFOF group (min-image
    periodic), union-find, size renumber (reference: per-group phase-tree
    FOF, search.cxx:552-576)."""
    pos = np.asarray(pos, np.float64)
    vel = np.asarray(vel, np.float64)
    pfof3 = np.asarray(pfof3)
    n = len(pfof3)
    all_pairs = []
    for g in np.unique(pfof3[pfof3 > 0]):
        idx = np.nonzero(pfof3 == g)[0]
        p, v = pos[idx], vel[idx]
        dx = p[:, None, :] - p[None, :, :]
        dx -= boxsize * np.round(dx / boxsize)
        d2 = np.sum(dx * dx, -1)
        dv2 = np.sum((v[:, None, :] - v[None, :, :]) ** 2, -1)
        adj = d2 / ell6d ** 2 + dv2 / vscale2 <= 1.0
        iu, ju = np.triu_indices(len(idx), k=1)
        sel = adj[iu, ju]
        all_pairs.append(np.stack([idx[iu[sel]], idx[ju[sel]]], axis=1))
    pairs = np.concatenate(all_pairs) if all_pairs else \
        np.empty((0, 2), np.int64)
    roots = _union_find(n, pairs)
    return renumber_by_size_oracle(roots, min_size)


def unwrap_group_oracle(pos: np.ndarray, boxsize: float) -> np.ndarray:
    """Min-image unwrap of ONE group's positions about its first member
    (the reference removes the periodic wrap per group before unbinding,
    search.cxx:856 AdjustStructureForPeriod)."""
    pos = np.asarray(pos, np.float64)
    d = pos - pos[0]
    return pos[0] + d - boxsize * np.round(d / boxsize)


def outlier_fit_oracle(R: np.ndarray, mass: np.ndarray,
                       skewfit: bool = True
                       ) -> Tuple[float, float, float, np.ndarray]:
    """(mode, sdlow, sdhigh, ell) from the R distribution — float64
    sequential mirror of the reference's outlier normalisation
    (reference localbgcomp.cxx:134-470
    ``DetermineDenVRatioDistribution`` + ``GetOutliersValues``:471, with
    the skew-Gaussian refinement of stf-fitting.h:11-48).

    Steps, as the reference: Sturges-rule histogram of R; mode = most
    probable bin centre; two-sided widths from the e^{-1/2} crossings
    either side of the peak (linear interpolation); Scott-rule rebin
    around the peak; weighted nonlinear LS fit of the piecewise
    skew-Gaussian A*exp(-(x-mu)^2 / (2 var s2)) [x<=mu] /
    A*exp(-(x-mu)^2/(2 var)) [x>mu], via scipy least_squares (an
    independent optimiser from the JAX LM path it validates);
    ell = (R-mode)/sdhigh above the mode, /sdlow below (GetOutliersValues).
    """
    R = np.asarray(R, np.float64)
    m = np.asarray(mass, np.float64)
    n = len(R)
    nbins = int(math.ceil(math.log10(n) / math.log10(2.0) + 1) * 4)
    rmin, rmax = float(R.min()), float(R.max())
    # reference binning: span 4|rmin| from a slightly lowered rmin
    deltar = 4.0 * abs(rmin) / nbins
    if deltar <= 0:
        deltar = max((rmax - rmin) / nbins, 1e-12)
    lo = rmin - deltar * 0.025
    deltar *= 1.05
    hist = np.zeros(nbins)
    for x, w in zip(R, m):
        ir = int((x - lo) / deltar)
        if 0 <= ir < nbins:
            hist[ir] += w
    ip = int(np.argmax(hist))
    mode = (ip + 0.5) * deltar + lo
    thr = math.exp(-0.5) * hist[ip]
    sdlow = sdhigh = deltar
    for i in range(ip, -1, -1):
        if hist[i] <= thr:
            sdlow = mode - (((thr - hist[i]) /
                             max(hist[i + 1] - hist[i], 1e-300)
                             + i + 0.5) * deltar + lo)
            break
    else:
        sdlow = ip * deltar
    for i in range(ip, nbins):
        if hist[i] <= thr:
            sdhigh = ((((thr - hist[i - 1]) /
                        min(hist[i] - hist[i - 1], -1e-300)
                        + i - 0.5) * deltar + lo) - mode)
            break
    else:
        sdhigh = (nbins - 1 - ip) * deltar
    sdlow = max(sdlow, 1e-6)
    sdhigh = max(sdhigh, 1e-6)

    if skewfit:
        from scipy.optimize import least_squares

        # Scott-rule rebin around the peak
        lo2 = mode - 4.0 * sdlow
        hi2 = mode + 4.0 * sdhigh
        sel = (R >= lo2) & (R < hi2)
        npeak = max(int(sel.sum()), 2)
        d2 = 3.5 * math.sqrt(sdlow ** 2 + sdhigh ** 2) / npeak ** (1 / 3)
        nb2 = max(int(math.ceil((hi2 - lo2) / d2 + 1)), 8)
        w2 = (hi2 - lo2) / nb2
        rbin = np.zeros(nb2)
        for x, w in zip(R[sel], m[sel]):
            rbin[min(int((x - lo2) / w2), nb2 - 1)] += w
        xbin = lo2 + (np.arange(nb2) + 0.5) * w2

        def resid(p):
            A, mu, var, s2 = p
            var, s2 = max(var, 1e-12), max(s2, 1e-12)
            dx2 = (xbin - mu) ** 2
            mdl = np.where(xbin <= mu, A * np.exp(-0.5 * dx2 / (var * s2)),
                           A * np.exp(-0.5 * dx2 / var))
            return mdl - rbin

        p0 = [float(rbin.max()), mode, sdhigh ** 2 * 0.8, 1.0]
        try:
            fit = least_squares(resid, p0, method="lm", max_nfev=2000)
            A, mu, var, s2 = fit.x
            if np.isfinite([A, mu, var, s2]).all() and var > 0 and s2 > 0:
                mode = float(mu)
                sdlow = float(math.sqrt(var * s2))
                sdhigh = float(math.sqrt(var))
        except Exception:
            pass
    d = R - mode
    ell = np.where(d > 0, d / sdhigh, d / sdlow)
    return mode, sdlow, sdhigh, ell


def core_growth_oracle(pos: np.ndarray, vel: np.ndarray, mass: np.ndarray,
                       valid: np.ndarray, pfof_sub: np.ndarray,
                       core: np.ndarray, ncores: int,
                       iters: int = 4) -> np.ndarray:
    """Phase-tensor core growth — float64 sequential mirror of the
    reference's Mahalanobis core assignment
    (reference search.cxx:1880-2024 ``HaloCoreGrowth`` with
    ``iPhaseCoreGrowth``): per-core mass-weighted 6D phase mean and
    dispersion tensor, every untagged particle assigned to the core of
    smallest Mahalanobis phase distance, dispersion tensors recomputed
    each growth step.  Returns the final core id per particle.
    """
    phase = np.concatenate([np.asarray(pos, np.float64),
                            np.asarray(vel, np.float64)], axis=1)
    m = np.asarray(mass, np.float64)
    core = np.asarray(core).copy()
    assignable = np.asarray(valid) & (np.asarray(pfof_sub) == 0)
    n = len(core)
    for _ in range(iters):
        mu = np.zeros((ncores + 1, 6))
        icov = np.zeros((ncores + 1, 6, 6))
        for c in range(1, ncores + 1):
            sel = (core == c) & np.asarray(valid)
            if not sel.any():
                icov[c] = np.eye(6)
                continue
            w = m[sel]
            mt = w.sum()
            mu[c] = (phase[sel] * w[:, None]).sum(0) / mt
            d = phase[sel] - mu[c]
            cov = np.einsum("ni,nj,n->ij", d, d, w) / mt
            tr = np.trace(cov) / 6.0
            cov = cov + 1e-6 * max(tr, 1e-20) * np.eye(6)
            icov[c] = np.linalg.inv(cov)
        newcore = core.copy()
        for i in range(n):
            if not assignable[i]:
                continue
            best, bestd = 1, np.inf
            for c in range(1, ncores + 1):
                d = phase[i] - mu[c]
                D2 = d @ icov[c] @ d
                if D2 < bestd:
                    bestd, best = D2, c
            newcore[i] = best
        core = newcore
    return core
