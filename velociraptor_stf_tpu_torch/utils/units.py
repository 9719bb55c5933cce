"""Units and cosmology.

The port's copy of ``velociraptor_stf_tpu/utils/units.py``, kept so that
the port imports nothing of the JAX package.

Reimplementation of the reference's cosmology helpers
(reference substructureproperties.cxx:4473-4536: ``CalcOmegak``,
``CalcCriticalDensity``, ``CalcBackgroundDensity``, ``CalcVirBN98``,
``CalcCosmoParams``, ``GetHubble``, ``CalcCosmicTime``).

These are scalar host-side computations (plain Python floats) — they set up
constants that feed the device pipeline, and the cosmic-time
quadrature uses numpy.
"""

from __future__ import annotations

import math

import numpy as np

from .config import Options


def get_hubble(opt: Options, a: float) -> float:
    """H(a) in internal units (reference GetHubble)."""
    return opt.h * opt.H * math.sqrt(
        opt.Omega_k * a ** -2.0
        + opt.Omega_m * a ** -3.0
        + opt.Omega_r * a ** -4.0
        + opt.Omega_Lambda
        + opt.Omega_de * a ** (-3.0 * (1 + opt.w_de))
    )


def calc_omegak(opt: Options) -> None:
    opt.Omega_k = (
        1 - opt.Omega_m - opt.Omega_Lambda - opt.Omega_r - opt.Omega_nu - opt.Omega_de
    )


def calc_critical_density(opt: Options, a: float) -> None:
    hubble = get_hubble(opt, a)
    opt.rhocrit = 3.0 * hubble * hubble / (8.0 * math.pi * opt.G)


def calc_background_density(opt: Options, a: float) -> None:
    hubble = get_hubble(opt, 1.0)
    opt.rhobg = 3.0 * hubble * hubble / (8.0 * math.pi * opt.G) * opt.Omega_m / a ** 3


def calc_vir_bn98(opt: Options, a: float) -> None:
    """Bryan & Norman (1998) virial overdensity (reference CalcVirBN98)."""
    bnx = -(opt.Omega_k * a ** -2.0 + opt.Omega_Lambda) / (
        opt.Omega_k * a ** -2.0 + opt.Omega_m * a ** -3.0 + opt.Omega_Lambda
    )
    opt.virBN98 = 18.0 * math.pi * math.pi + 82.0 * bnx - 39.0 * bnx * bnx


def calc_cosmo_params(opt: Options, a: float) -> None:
    """Reference CalcCosmoParams: set Omega_k, rhocrit, rhobg, virBN98."""
    calc_omegak(opt)
    calc_critical_density(opt, a)
    calc_background_density(opt, a)
    calc_vir_bn98(opt, a)
    if opt.virlevel < 0:
        opt.virlevel = opt.virBN98


def calc_cosmic_time(opt: Options, a1: float, a2: float) -> float:
    """Cosmic time between scale factors in years (reference CalcCosmicTime,
    GSL qags replaced by fixed-order Gauss-Legendre quadrature)."""

    def inv_aH(a: np.ndarray) -> np.ndarray:
        Hq = np.sqrt(
            opt.Omega_k * a ** -2.0
            + opt.Omega_m * a ** -3.0
            + opt.Omega_r * a ** -3.0
            + opt.Omega_Lambda
            + opt.Omega_de * a ** (-3.0 * (1 + opt.w_de))
        )
        return 1.0 / (a * Hq)

    x, w = np.polynomial.legendre.leggauss(128)
    mid, half = 0.5 * (a1 + a2), 0.5 * (a2 - a1)
    result = float(np.sum(w * inv_aH(mid + half * x)) * half)
    # 1.02269032e-9: (km/s/kpc) -> 1/yr conversion, as in the reference
    return 1.0 / (opt.h * opt.H * opt.velocitytokms / opt.lengthtokpc * 1.02269032e-9) * result


def interparticle_spacing(boxsize: float, npart_total: int) -> float:
    """Mean interparticle spacing; the readers store this in opt.ellxscale
    (cf. gadgetio.cxx:1417, hdfio.cxx:1967)."""
    return boxsize / npart_total ** (1.0 / 3.0)
