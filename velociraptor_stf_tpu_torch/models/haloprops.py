"""Bulk halo characterisation for linking-length scaling.

The port's copy of ``velociraptor_stf_tpu/models/haloprops.py`` (numpy
only), kept so that the port imports nothing of the JAX package.

Equivalent of the reference haloproperties.cxx — the
single-halo-mode prepass that rescales ``ellxscale``/``ellvscale`` from the
loaded halo's bulk properties (``ScaleLinkingLengths``:13, called from
main.cxx:333 when ``iScaleLengths`` in the single-halo branch):

* ``adjust_to_cm`` (:37): iterative shrinking-sphere CM (radius shrinks
  by 0.9 per step until the CM converges or <10% of particles remain),
  then radial extents and the maximum circular velocity in the CM frame;
* ``virial_quantities`` (:201): log-radial binning (N^(1/3) bins),
  average enclosed density crossing of ``rhoc * virlevel`` for
  (Rvir, Mvir), and the radii enclosing [20%, 50%, 80%] of the mass;
* ``scale_linking_lengths``: sets ``opt.ellxscale = (Rscale - rmin) /
  N^(1/3)`` and ``opt.ellvscale = Vcirc(Rscale)``, with the 80%-mass
  radius substituted for Rvir in gas/star-only searches.

One pass over a single halo's particles at load time: plain vectorised
NumPy on the host (the data is host-resident pre-pipeline; reference uses
OpenMP reductions).
"""

from __future__ import annotations

import math

import numpy as np

from ..utils import config as C


def adjust_to_cm(pos: np.ndarray, vel: np.ndarray, mass: np.ndarray,
                 tol: float = 1e-2):
    """(cm, cmvel, rlim[3], maxvcirc, r_sorted, Mcum_sorted).

    Reference AdjusttoCM (haloproperties.cxx:37): shrink the search sphere
    by 0.9 per iteration about the running CM until the relative CM change
    drops below ``tol`` or fewer than 10% of particles remain inside.
    """
    pos = np.asarray(pos, np.float64)
    vel = np.asarray(vel, np.float64)
    m = np.asarray(mass, np.float64)
    n = len(m)
    mtot = m.sum()
    cmold = (pos * m[:, None]).sum(0) / mtot
    cmvel = (vel * m[:, None]).sum(0) / mtot
    ri = np.max(np.linalg.norm(pos - cmold, axis=1))
    cm = cmold.copy()
    change = np.inf
    while change > tol:
        ri *= 0.9
        d = np.linalg.norm(pos - cmold, axis=1)
        inside = d <= ri
        encm = m[inside].sum()
        if encm <= 0:
            break
        cm = (pos[inside] * m[inside, None]).sum(0) / encm
        if inside.sum() < 0.1 * n:
            break
        change = np.max(np.abs((cm - cmold) /
                               np.where(cmold != 0, cmold, 1.0)))
        cmold = cm.copy()

    r = np.linalg.norm(pos - cm, axis=1)
    order = np.argsort(r, kind="stable")
    r_s = np.maximum(r[order], 1e-30)
    Mcum = np.cumsum(m[order])
    G = 1.0  # scalings are relative; G multiplies through Vcirc below
    vc = np.sqrt(Mcum / r_s)
    rlim = np.array([0.99 * r_s[0],
                     float((r * m).sum() / mtot),
                     1.01 * r_s[-1]])
    return cm, cmvel, rlim, float(vc.max()), r_s, Mcum


def virial_quantities(r_s: np.ndarray, Mcum: np.ndarray, rlim, rhoc: float,
                      virlevel: float, menc_fracs=(0.2, 0.5, 0.8)):
    """(Rvir, Mvir, Renc[]) from log-binned average enclosed density.

    Reference GetVirialQuantities (haloproperties.cxx:201): nbins =
    N^(1/3) log bins over [rlim[0], rlim[2]]; Rvir at the outermost
    crossing of rho_ave = rhoc * virlevel (log-interpolated); Renc at the
    enclosed-mass fractions (log-interpolated)."""
    n = len(r_s)
    mtot = Mcum[-1]
    nbins = max(int(n ** (1.0 / 3.0)), 4)
    lgmin = math.log10(max(rlim[0], 1e-30))
    dlg = (math.log10(max(rlim[2], rlim[0] * 1.0001)) - lgmin) / nbins
    ib = np.clip(((np.log10(r_s) - lgmin) / dlg).astype(np.int64),
                 0, nbins - 1)
    mbin = np.bincount(ib, weights=np.diff(np.concatenate([[0.0], Mcum])),
                       minlength=nbins)
    mencb = np.cumsum(mbin)
    redge = 10.0 ** (lgmin + dlg * (np.arange(nbins) + 1))
    rhoave = mencb / (4.0 * math.pi / 3.0 * redge ** 3)
    rhovir = rhoc * virlevel

    renc = np.zeros(len(menc_fracs))
    it = 0
    for j in range(nbins - 1):
        while (it < len(menc_fracs) and mencb[j] / mtot < menc_fracs[it]
                < mencb[j + 1] / mtot):
            f = (menc_fracs[it] - mencb[j] / mtot) / \
                (mencb[j + 1] / mtot - mencb[j] / mtot)
            renc[it] = 10.0 ** (lgmin + dlg * (j + 1.0) + f * dlg)
            it += 1
        if it == len(menc_fracs):
            break
    rvir, mvir = float(rlim[2]), float(mtot)
    for j in range(nbins - 2, -1, -1):
        if rhoave[j] / rhovir > 1.0 and rhoave[j + 1] / rhovir < 1.0:
            f = (1.0 - rhoave[j] / rhovir) / \
                (rhoave[j + 1] / rhovir - rhoave[j] / rhovir)
            rvir = 10.0 ** (lgmin + dlg * (j + 1.0) + f * dlg)
            mvir = mencb[j] + (mencb[j + 1] - mencb[j]) / dlg * \
                (math.log10(rvir) - (lgmin + dlg * (j + 1.0)))
            break
    return rvir, mvir, renc


def scale_linking_lengths(opt: C.Options, pos, vel, mass) -> None:
    """Mutate opt.ellxscale / opt.ellvscale from the halo's bulk scales
    (reference ScaleLinkingLengths, haloproperties.cxx:13-30)."""
    n = len(np.asarray(mass))
    cm, cmvel, rlim, maxvc, r_s, Mcum = adjust_to_cm(pos, vel, mass)
    rhoc = 1.19e-7   # reference hardwires G=1 units here (:17)
    rvir, mvir, renc = virial_quantities(
        r_s, Mcum, rlim, rhoc, opt.virlevel if opt.virlevel > 0 else 200.0)
    if opt.partsearchtype in (C.PSTGAS, C.PSTSTAR):
        rscale = renc[2] if renc[2] > 0 else rvir
        menc80 = 0.8 * Mcum[-1]
        vscale = math.sqrt(opt.G * menc80 / max(rscale, 1e-30))
    else:
        rscale = rvir
        vscale = math.sqrt(opt.G * mvir / max(rvir, 1e-30))
    opt.ellxscale = abs(rscale - rlim[0]) / n ** (1.0 / 3.0)
    opt.ellvscale = vscale
