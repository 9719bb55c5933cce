"""Synthetic snapshot generation for tests and benchmarks.

The port's copy of ``velociraptor_stf_tpu/io/synthetic.py``, kept so that
the port imports nothing of the JAX package.

The reference has no unit tests (SURVEY.md §4); its validation method is
catalog comparison on real snapshots.  We build the missing test layer with
planted-halo mocks: isotropic halo blobs (Plummer/Hernquist-like profiles)
with self-consistent velocity dispersions on top of a uniform Poisson
background whose density is far below the FOF percolation threshold, so the
planted memberships are (statistically) the unique FOF answer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class MockSpec:
    npart_background: int = 20000
    nhalos: int = 8
    particles_per_halo: int = 800
    boxsize: float = 1.0
    halo_scale_radius: float = 0.004   # in box units; compact vs linking length
    halo_sigma_v: float = 150.0        # km/s velocity dispersion inside halos
    background_sigma_v: float = 50.0
    mass: float = 1.0
    seed: int = 1234


def plummer_radii(rng: np.random.Generator, n: int, a: float) -> np.ndarray:
    """Sample radii from a Plummer profile with scale radius a."""
    u = rng.uniform(size=n)
    # Plummer: M(<r)/M = r^3/(r^2+a^2)^{3/2}  =>  r = a * (u^{-2/3} - 1)^{-1/2}
    return a / np.sqrt(u ** (-2.0 / 3.0) - 1.0)


def make_mock(spec: MockSpec = MockSpec()):
    """Generate (pos, vel, mass, truth_labels) with planted halos.

    truth_labels: -1 for background, halo index >= 0 for members.
    Positions are periodic in [0, boxsize).
    """
    rng = np.random.default_rng(spec.seed)
    L = spec.boxsize
    nh, nph = spec.nhalos, spec.particles_per_halo
    ntot = spec.npart_background + nh * nph

    pos = np.empty((ntot, 3), np.float64)
    vel = np.empty((ntot, 3), np.float64)
    labels = np.full(ntot, -1, np.int64)

    # background
    nb = spec.npart_background
    pos[:nb] = rng.uniform(0, L, size=(nb, 3))
    vel[:nb] = rng.normal(0, spec.background_sigma_v, size=(nb, 3))

    # halo centres placed away from each other (rejection sampling)
    centres = []
    min_sep = 10 * spec.halo_scale_radius
    while len(centres) < nh:
        c = rng.uniform(0.15 * L, 0.85 * L, size=3)
        if all(np.linalg.norm(c - d) > min_sep for d in centres):
            centres.append(c)
    centres = np.array(centres)

    for hi in range(nh):
        s = nb + hi * nph
        r = plummer_radii(rng, nph, spec.halo_scale_radius)
        # clip the sampled Plummer tail so each planted halo stays compact
        r = np.minimum(r, 6 * spec.halo_scale_radius)
        direc = rng.normal(size=(nph, 3))
        direc /= np.linalg.norm(direc, axis=1, keepdims=True)
        pos[s:s + nph] = (centres[hi] + r[:, None] * direc) % L
        hvel = rng.normal(0, 400, size=3)  # bulk motion
        vel[s:s + nph] = hvel + rng.normal(0, spec.halo_sigma_v, size=(nph, 3))
        labels[s:s + nph] = hi

    mass = np.full(ntot, spec.mass, np.float64)
    # shuffle so particle order carries no information
    perm = rng.permutation(ntot)
    return pos[perm], vel[perm], mass[perm], labels[perm]


def fof_oracle(pos: np.ndarray, linking_length: float,
               boxsize: Optional[float] = None) -> np.ndarray:
    """Exact FOF group labels via scipy KD-tree + sparse connected components.

    Host-side oracle used by tests to verify the FOF engines on arbitrary
    configurations (replaces the reference's catalog-comparison validation).
    Returns an (N,) array of component ids (0..ncomp-1).
    """
    from scipy import sparse
    from scipy.spatial import cKDTree

    tree = cKDTree(pos, boxsize=boxsize)
    pairs = tree.query_pairs(linking_length, output_type="ndarray")
    n = pos.shape[0]
    if len(pairs) == 0:
        return np.arange(n)
    data = np.ones(len(pairs), dtype=np.int8)
    m = sparse.coo_matrix((data, (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    _, comp = sparse.csgraph.connected_components(m, directed=False)
    return comp


def labels_match_rate(a: np.ndarray, b: np.ndarray, min_size: int = 1) -> float:
    """Fraction of particles whose group assignment is partition-consistent
    between labelings a and b (groups smaller than min_size in `a` ignored).

    This is the TreeFrog-style match metric used by the reference's
    examples/catalogcomparisontolerancecheck.py, reduced to one snapshot.
    """
    import collections

    ca = collections.Counter(a.tolist())
    keep = np.array([ca[x] >= min_size for x in a.tolist()])
    if keep.sum() == 0:
        return 1.0
    a, b = a[keep], b[keep]
    # best-overlap mapping a-group -> b-group
    pairs = collections.Counter(zip(a.tolist(), b.tolist()))
    besta: dict = {}
    for (ga, gb), c in pairs.items():
        if ga not in besta or c > besta[ga][1]:
            besta[ga] = (gb, c)
    matched = sum(c for (ga, gb), c in pairs.items() if besta[ga][0] == gb)
    return matched / len(a)


def make_cosmo_mock(npart_total: int, fhalo: float = 0.4, nhalos: int = 256,
                    boxsize: float = 100.0, seed: int = 7,
                    slope: float = -1.8, sigma8_vel: float = 300.0,
                    G: float = 43.0211349):
    """Vectorised large mock for benchmarks: power-law halo mass function.

    ``fhalo`` of the particles live in ``nhalos`` NFW-ish blobs whose sizes
    follow a power-law; the rest are uniform background.  Velocities:
    background Hubble-ish random; halo members = bulk + dispersion tied to
    size (sigma ~ n^(1/3)), so 6DFOF and unbinding have realistic work.
    Returns (pos, vel, mass) float32.
    """
    rng = np.random.default_rng(seed)
    nh = int(npart_total * fhalo)
    nb = npart_total - nh
    # power-law halo occupancies
    u = rng.uniform(size=nhalos)
    w = u ** (1.0 / (slope + 1.0)) if slope != -1.0 else np.exp(u)
    sizes = np.maximum((w / w.sum() * nh).astype(np.int64), 32)
    sizes[-1] += nh - sizes.sum()
    if sizes[-1] < 32:
        sizes[-1] = 32
    nh = int(sizes.sum())
    npart = nb + nh

    pos = np.empty((npart, 3), np.float32)
    vel = np.empty((npart, 3), np.float32)
    pos[:nb] = rng.uniform(0, boxsize, (nb, 3)).astype(np.float32)
    vel[:nb] = rng.normal(0, 100.0, (nb, 3)).astype(np.float32)

    centres = rng.uniform(0, boxsize, (nhalos, 3))
    halo_ids = np.repeat(np.arange(nhalos), sizes)
    n_members = sizes[halo_ids].astype(np.float64)
    # scale radius ~ n^(1/3) keeps core overdensity fixed at ~900x mean, so
    # internal separations (~0.1 d_mean) stay far below b = 0.2 d_mean and
    # FOF/6DFOF hold the blobs together like real NFW cores
    d_mean = boxsize / npart_total ** (1 / 3)
    rs = (0.3 * d_mean) * (n_members / 100.0) ** (1 / 3)
    uu = rng.uniform(size=nh)
    radii = rs / np.sqrt(np.maximum(uu ** (-2 / 3) - 1.0, 1e-4))
    radii = np.minimum(radii, 6 * rs)
    dirs = rng.normal(size=(nh, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pos[nb:] = np.mod(centres[halo_ids] + radii[:, None] * dirs,
                      boxsize).astype(np.float32)
    bulk = rng.normal(0, sigma8_vel, (nhalos, 3))
    # near-virial internal dispersion: sigma_1d^2 = G M / (6 rs)
    sig = np.sqrt(G * n_members / (6.0 * rs))
    vel[nb:] = (bulk[halo_ids] +
                rng.normal(size=(nh, 3)) * sig[:, None]).astype(np.float32)
    mass = np.full(npart, 1.0, np.float32)
    perm = rng.permutation(npart)
    return pos[perm], vel[perm], mass[perm]


# G in (km/s)^2 kpc / (1e10 Msun), the planted-subhalo mocks' unit system
G_KMS = 43.0211349


def host_with_subhalo(seed: int = 0, nhost: int = 6000, nsub: int = 600,
                      rsub: float = 0.06, sub_offset: float = 0.45,
                      sub_sigma: float = 6.0):
    """A host halo (unit sphere, denser centre, virial Maxwellian
    velocities, total mass 100) with a compact cold subhalo offset along
    x and moving in y: (pos, vel, mass, member) float32, ``member`` True
    on the subhalo (the planted mock of tests/test_substructure.py)."""
    rng = np.random.default_rng(seed)
    mtot = 100.0
    r = rng.uniform(size=nhost) ** (1 / 2)
    d = rng.normal(size=(nhost, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hpos = r[:, None] * d
    sigma = np.sqrt(G_KMS * mtot / 6.0)
    hvel = rng.normal(0, sigma, (nhost, 3))
    spos = sub_offset * np.array([1.0, 0, 0]) + \
        rsub * rng.normal(size=(nsub, 3)) / np.sqrt(3)
    svel = np.array([0.0, 1.6 * sigma, 0.0]) + \
        rng.normal(0, sub_sigma, (nsub, 3))
    pos = np.concatenate([hpos, spos]).astype(np.float32)
    vel = np.concatenate([hvel, svel]).astype(np.float32)
    mass = np.full(len(pos), mtot / len(pos), np.float32)
    member = np.concatenate([np.zeros(nhost, bool), np.ones(nsub, bool)])
    return pos, vel, mass, member


def planted_subhalos(nhosts: int = 3, seed: int = 10, nhost: int = 3000,
                     nsub: int = 400, spacing: float = 4.0,
                     offset: float = 0.0):
    """``nhosts`` hosts of ``host_with_subhalo`` (seeds seed, seed+1, ...)
    ``spacing`` apart along x from x = ``offset``: (pos, vel, mass, host)
    with ``host`` the 1-based host of each particle (the three-host mock
    of tests/test_substructure.py:400-421 at the defaults)."""
    parts = [host_with_subhalo(seed=seed + k, nhost=nhost, nsub=nsub)
             for k in range(nhosts)]
    shift = [np.array([offset + spacing * k, offset, offset], np.float32)
             for k in range(nhosts)]
    pos = np.concatenate([p[0] + s for p, s in zip(parts, shift)])
    vel = np.concatenate([p[1] for p in parts])
    mass = np.concatenate([p[2] for p in parts])
    host = np.concatenate([np.full(len(p[0]), k + 1, np.int32)
                           for k, p in enumerate(parts)])
    return pos, vel, mass, host


# example_snapshot's default box: one planted host with a cold subhalo,
# 24 small halos and 8192 uniform particles, the smallest input on which
# every config under examples/ finds the subhalo as a substructure
EXAMPLE_BOXSIZE = 19.0


def example_snapshot(kind: str = "dm", nhosts: int = 1, nbg: int = 8192,
                     boxsize: float = EXAMPLE_BOXSIZE, spacing: float = 6.0,
                     seed: int = 10, nhost: int = 3000, nsub: int = 400,
                     sub_sigma: float = 3.0, nsmall: int = 24,
                     nlowres: int = 256, mass: float = 2.0 ** -5):
    """Particles for the configs under ``examples/``: ``nhosts`` planted
    hosts with a subhalo each (``host_with_subhalo`` with ``sub_sigma``,
    seeds seed, seed+1, ...) on a cubic lattice ``spacing`` apart from
    (spacing, spacing, spacing), ``nsmall`` small virialised halos of
    40-300 particles at least 2 away from every host, and ``nbg``
    uniform particles (velocities N(0, 50)) in a periodic box, all of
    particle mass ``mass``.  ``kind`` "hydro" adds gas (type 0) copies of
    a random sixth of all particles (positions + N(0, 0.005), mass / 8);
    "zoom" adds to that ``nlowres`` uniform low-resolution particles
    (type 2, 8x the mass, velocities N(0, 60)) and eight more inside each
    host, at its velocity dispersion.  With the default masses, powers
    of two, every float32 sum of masses is exact, so two codes that add
    them in different orders agree.  Returns (pos, vel, mass) float32
    and ptype int8."""
    if kind not in ("dm", "hydro", "zoom"):
        raise ValueError(f"unknown kind {kind!r}")
    rng = np.random.default_rng(seed + 1000)
    side = max(1, int(np.ceil(nhosts ** (1 / 3) - 1e-9)))
    if spacing * (side + 0.5) > boxsize:
        raise ValueError(f"{nhosts} hosts {spacing} apart do not fit a box "
                         f"of {boxsize}")
    parts = [host_with_subhalo(seed=seed + k, nhost=nhost, nsub=nsub,
                               sub_sigma=sub_sigma) for k in range(nhosts)]
    cells = np.arange(nhosts)
    lattice = np.stack([cells % side, cells // side % side,
                        cells // side ** 2], 1)
    centres = (spacing * (lattice + 1)).astype(np.float32)
    m0 = np.float32(mass)
    pos = [p[0] + c for p, c in zip(parts, centres)]
    vel = [p[1] for p in parts]
    for _ in range(nsmall):
        while True:
            c = rng.uniform(1.0, boxsize - 1.0, 3)
            if not nhosts or np.min(np.linalg.norm(centres - c, axis=1)) > 2:
                break
        k = int(rng.integers(40, 301))
        rad = 0.15 * (k / 100.0) ** (1 / 3)
        d = rng.normal(size=(k, 3))
        d *= (rad * rng.uniform(size=k) ** 0.5 /
              np.linalg.norm(d, axis=1))[:, None]
        sig = np.sqrt(G_KMS * k * m0 / (6.0 * rad))
        pos.append((c + d).astype(np.float32))
        vel.append((rng.normal(0, 100.0, 3) +
                    rng.normal(0, sig, (k, 3))).astype(np.float32))
    pos.append(rng.uniform(0, boxsize, (nbg, 3)).astype(np.float32))
    vel.append(rng.normal(0, 50.0, (nbg, 3)).astype(np.float32))
    pos, vel = np.concatenate(pos), np.concatenate(vel)
    mass = np.full(len(pos), m0, np.float32)
    ptype = np.ones(len(pos), np.int8)
    if kind != "dm":
        g = rng.choice(len(pos), len(pos) // 6, replace=False)
        gpos = np.mod(pos[g] + rng.normal(0, 0.005, (len(g), 3)),
                      boxsize).astype(np.float32)
        pos = np.concatenate([pos, gpos])
        vel = np.concatenate([vel, vel[g]])
        mass = np.concatenate([mass, mass[g] / np.float32(8)])
        ptype = np.concatenate([ptype, np.zeros(len(g), np.int8)])
    if kind == "zoom":
        sigma = np.sqrt(G_KMS * 100.0 / 6.0)
        inner = np.repeat(np.arange(nhosts), 8)
        d = rng.normal(size=(len(inner), 3))
        d *= (rng.uniform(0.1, 0.6, len(inner)) /
              np.linalg.norm(d, axis=1))[:, None]
        lpos = np.concatenate([rng.uniform(0, boxsize, (nlowres, 3)),
                               centres[inner] + d]).astype(np.float32)
        lvel = np.concatenate([rng.normal(0, 60.0, (nlowres, 3)),
                               rng.normal(0, sigma, (len(inner), 3))])
        pos = np.concatenate([pos, lpos])
        vel = np.concatenate([vel, lvel.astype(np.float32)])
        mass = np.concatenate([mass, np.full(len(lpos), 8 * m0, np.float32)])
        ptype = np.concatenate([ptype, np.full(len(lpos), 2, np.int8)])
    return pos, vel, mass, ptype
