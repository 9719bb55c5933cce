"""The snapshot generator: a periodic cosmological box of planted halos.

One general generator for every traffic mix whose file names
``"generator": "cosmo_box"``.  The configuration's file gives the volume
(comoving box, particles per side, species) and the cosmology; the
traffic mix gives the epoch and the halo population.  Lengths are
physical, the comoving box times the scale factor, as the configs'
``Comoving_units=0`` asks of the finder; velocities are peculiar.

Halo sizes are the quantiles, not random draws, of dN/dM ~ M^-slope
between ``m_min`` and ``m_max`` dark-matter particles, so every seed
gives the same sizes.  Where the mix names a ``halo_seed``, the halos'
and subhalos' own particles (offsets from the centre, velocities about
the bulk, the subhalos' orbits) are drawn from it, the same for every
seed, so that the substructure search has the same work whatever the
seed; the seed places the halos, gives their bulk velocities, the
background, the gas's scatter, the stars and the particles' order.  Each halo is a Plummer sphere truncated at 2.5
scale radii, sized so that its mean density is ``halo_overdensity``
times the mean particle density: its edge then lies well above the
3D linking length's density, so a halo is one FOF group.  Velocities
are Gaussian at the local Plummer dispersion, capped below the local
escape speed, so the members are bound in the config's own units.
Hosts of ``sub_min_host`` particles or more carry planted subhalos
holding up to ``sub_share`` of their particles: denser, cold, on circular
orbits at half the host's radius (``host_with_subhalo``'s recipe).  The
rest of the dark matter is a uniform background.  Hydro volumes add one
gas particle per dark-matter particle at the EAGLE initial conditions'
offset (half a cell along the diagonal), shrunk by the halo's collapse
inside halos; ``star_share`` of the gas in halos of ``star_min_halo``
particles or more becomes stars.

Halo centres (a few thousand numbers) are drawn on the host; every
per-particle array is drawn on ``device`` with a ``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

DARK, GAS, STAR = 1, 0, 4


@dataclass
class Snapshot:
    pos: torch.Tensor            # (N, 3) float32, physical, in [0, box)
    vel: torch.Tensor            # (N, 3) float32 peculiar velocities
    mass: torch.Tensor           # (N,) float32
    boxsize: float
    a: float
    ptype: Optional[torch.Tensor] = None      # (N,) int8, None for DM only
    extras: Dict[str, torch.Tensor] = field(default_factory=dict)
    # planted subhalo of each particle (-1: none), the subhalos' sizes and
    # the halo (an index of ``halo_sizes``) each is planted in
    sub_of: Optional[torch.Tensor] = None
    sub_sizes: Optional[np.ndarray] = None
    sub_host: Optional[np.ndarray] = None
    halo_sizes: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return int(self.pos.shape[0])


def quantile_sizes(n: int, m_min: float, m_max: float, slope: float
                   ) -> np.ndarray:
    """``n`` sizes at the mid quantiles (k + 1/2) / n of dN/dM ~ M^-slope
    on [m_min, m_max], largest first, rounded to whole particles."""
    if n <= 0:
        return np.zeros(0, np.int64)
    e = 1.0 - slope
    u = (np.arange(n) + 0.5) / n
    lo, hi = m_min ** e, m_max ** e
    sizes = np.round((lo - u * (lo - hi)) ** (1.0 / e)).astype(np.int64)
    return np.sort(sizes)[::-1].copy()


def subhalo_sizes(n_host: int, share: float, m_min: int, slope: float
                  ) -> np.ndarray:
    """Planted subhalo sizes of a host of ``n_host`` particles: quantile
    sizes of the same law from ``m_min`` up to half the subhalos' total,
    as many as bring the total to ``share`` of the host, the last one
    trimmed to that total and dropped when that leaves it under
    ``m_min``: at most ``share`` of the host."""
    total = int(round(share * n_host))
    if total < m_min:
        return np.zeros(0, np.int64)
    top = max(float(m_min), 0.5 * total)
    k = 1
    while True:
        s = quantile_sizes(k, m_min, top, slope)
        if s.sum() >= total or k > total // m_min:
            break
        k += 1
    s = s.copy()
    over = int(s.sum()) - total
    while over > 0 and len(s):
        cut = min(over, int(s[-1]))
        s[-1] -= cut
        over -= cut
        if s[-1] < m_min:
            s = s[:-1]
    return s


def particle_masses(cfg: dict, entries: Dict[str, float]) -> Dict[str, float]:
    """Dark-matter and gas particle masses: the config's mean densities
    (critical density 3 H0^2 / (8 pi G), H0 = Hubble_unit * h_val) times
    the comoving volume over the particles of one species."""
    G = entries["Gravity"]
    H0 = entries["Hubble_unit"] * entries["h_val"]
    rho_crit = 3.0 * H0 * H0 / (8.0 * math.pi * G)
    om, ob = entries["Omega_m"], entries.get("Omega_b", 0.0)
    vol = cfg["boxsize"] ** 3
    n = cfg["n_side"] ** 3
    if "gas" in cfg["species"]:
        return {"dark_matter": (om - ob) * rho_crit * vol / n,
                "gas": ob * rho_crit * vol / n}
    return {"dark_matter": om * rho_crit * vol / n}


def cfg_numbers(cfg: dict) -> Dict[str, float]:
    """The numeric keys of the configuration's ``cfg`` lines."""
    out = {}
    for line in cfg["cfg"]:
        k, v = line.split("=", 1)
        try:
            out[k] = float(v.rstrip(","))
        except ValueError:
            pass
    return out


def _place(rng: np.random.Generator, radii: np.ndarray, box: float,
           gap: float) -> np.ndarray:
    """Centres for spheres of ``radii`` (largest first) in a periodic box,
    no two closer than the sum of their radii plus ``gap``.  A draw is
    tested against the centres in the 27 grid cells around it, cells
    wider than the largest such distance, so the centres farther away
    could not refuse it: the same draws and centres as a test against
    every centre, in a time that grows with the number of halos and not
    with its square."""
    n = len(radii)
    centres = np.zeros((n, 3))
    reach = 2.0 * float(radii[0]) + gap if n else 0.0
    nc = int(box // (1.01 * reach)) if reach > 0 else 1
    if nc < 3:
        nc = 1          # one cell: every centre is tested
    offsets = np.array([(dx, dy, dz) for dx in (-1, 0, 1)
                        for dy in (-1, 0, 1) for dz in (-1, 0, 1)])
    if nc == 1:
        offsets = offsets[13:14]
    cells: Dict[Tuple[int, int, int], List[int]] = {}
    for i, r in enumerate(radii):
        for _ in range(10000):
            c = rng.uniform(0.0, box, 3)
            k = np.minimum((c * (nc / box)).astype(np.int64), nc - 1)
            near = np.array([j for o in (k + offsets) % nc
                             for j in cells.get(tuple(o.tolist()), ())],
                            np.int64)
            d = centres[near] - c
            d -= box * np.round(d / box)
            if i == 0 or np.all(np.einsum("ij,ij->i", d, d) >
                                (radii[near] + r + gap) ** 2):
                break
        else:
            raise RuntimeError("halos do not fit the box")
        centres[i] = c
        cells.setdefault(tuple(k.tolist()), []).append(i)
    return centres


def _unit_vectors(n: int, gen: torch.Generator, device) -> torch.Tensor:
    d = torch.randn(n, 3, generator=gen, device=device, dtype=torch.float64)
    return d / torch.clamp_min(d.norm(dim=1, keepdim=True), 1e-30)


def _plummer(counts: torch.Tensor, a: torch.Tensor, mtot: torch.Tensor,
             G: float, gen: torch.Generator, vfac: float):
    """Offsets and velocities of sum(counts) particles in truncated
    Plummer spheres (scale ``a``, cut at 2.5 a, total mass ``mtot`` each),
    float64: radii by the inverse cumulative mass, velocities Gaussian at
    the local dispersion GM/(6 sqrt(r^2 + a^2)) times ``vfac``^2, capped
    at 0.8 of the local escape speed."""
    dev = counts.device
    idx = torch.repeat_interleave(torch.arange(len(counts), device=dev),
                                  counts)
    n = int(idx.shape[0])
    xt = 2.5
    ft = xt ** 3 / (1 + xt * xt) ** 1.5
    u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64) * ft
    u = torch.clamp_min(u, 1e-12)
    x = 1.0 / torch.sqrt(torch.clamp_min(u ** (-2.0 / 3.0) - 1.0, 1e-12))
    ai, mi = a[idx], mtot[idx] / ft      # the untruncated sphere's mass
    r = x * ai
    off = r[:, None] * _unit_vectors(n, gen, dev)
    s = torch.sqrt(r * r + ai * ai)
    sig = vfac * torch.sqrt(G * mi / (6.0 * s))
    v = torch.randn(n, 3, generator=gen, device=dev,
                    dtype=torch.float64) * sig[:, None]
    vesc = torch.sqrt(2.0 * G * mi / s)
    speed = torch.clamp_min(v.norm(dim=1), 1e-30)
    v = v * torch.clamp_max(0.8 * vesc / speed, 1.0)[:, None]
    return idx, off, v, sig


def generate(cfg: dict, traffic: dict, seed: int,
             device="cuda") -> Snapshot:
    """The snapshot of configuration ``cfg`` under traffic mix
    ``traffic`` (their files' JSON) for ``seed``, on ``device``."""
    device = torch.device(device)
    e = cfg_numbers(cfg)
    G = e["Gravity"]
    t = traffic
    a = float(t["a"])
    # physical lengths (Comoving_units=0): the comoving box times a
    box = float(cfg["boxsize"]) * a
    n_side = int(cfg["n_side"])
    ndm = n_side ** 3
    d_mean = box / n_side
    masses = particle_masses(cfg, e)
    mdm = masses["dark_matter"]
    slope = float(t["slope"])
    sizes = quantile_sizes(int(t["n_halo"]), float(t["m_min"]),
                           float(t["m_max"]), slope)
    if sizes.sum() > ndm:
        raise ValueError("the halos hold more particles than the volume")
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    # the halos' own particles: from the mix's halo_seed where it has one
    hseed = int(t.get("halo_seed", seed))
    hrng = np.random.default_rng(hseed)
    hgen = torch.Generator(device=device)
    hgen.manual_seed(hseed % (2 ** 63))

    # halo radii: mean density halo_overdensity x the mean particle density
    over = float(t["halo_overdensity"])
    rt = d_mean * (3.0 * sizes / (4.0 * math.pi * over)) ** (1.0 / 3.0)
    b = 0.2 * d_mean
    centres = _place(rng, rt, box, 2.0 * b)
    bulk = rng.normal(0.0, float(t["bulk_sigma"]), (len(sizes), 3))

    # planted subhalos of the large hosts
    sub_share = float(t.get("sub_share", 0.0))
    sub_rows = []           # (host, size)
    if sub_share > 0:
        for h in np.nonzero(sizes >= int(t["sub_min_host"]))[0]:
            for s in subhalo_sizes(int(sizes[h]), sub_share,
                                   int(t["m_min"]), slope):
                sub_rows.append((h, int(s)))
    sub_host = np.array([h for h, _ in sub_rows], np.int64)
    sub_sizes = np.array([s for _, s in sub_rows], np.int64)
    body = sizes.copy()
    np.subtract.at(body, sub_host, sub_sizes)

    def dev64(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    # host bodies
    a_h = rt / 2.5
    hidx, off, v, _ = _plummer(torch.as_tensor(body, device=device),
                               dev64(a_h), dev64(body * mdm), G, hgen,
                               float(t["velocity_factor"]))
    hpos = dev64(centres)[hidx] + off
    hvel = dev64(bulk)[hidx] + v
    halo_of = hidx
    sub_of = torch.full((hpos.shape[0],), -1, dtype=torch.int64,
                        device=device)
    parts_pos, parts_vel = [hpos], [hvel]
    if len(sub_sizes):
        # on circular orbits at a random fraction of the host radius,
        # denser than the host by sub_overdensity, cold
        host_r = rt[sub_host]
        rr = hrng.uniform(0.3, 0.7, len(sub_sizes)) * host_r
        dirs = hrng.normal(size=(len(sub_sizes), 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        sc = centres[sub_host] + rr[:, None] * dirs
        # circular speed in the host's Plummer potential, perpendicular
        ah = a_h[sub_host]
        mh = sizes[sub_host] * mdm / (2.5 ** 3 / 7.25 ** 1.5)
        vc = np.sqrt(G * mh * rr * rr / (rr * rr + ah * ah) ** 1.5)
        perp = np.cross(dirs, hrng.normal(size=(len(sub_sizes), 3)))
        perp /= np.linalg.norm(perp, axis=1, keepdims=True)
        sv = bulk[sub_host] + vc[:, None] * perp
        rs = d_mean * (3.0 * sub_sizes / (4.0 * math.pi * over *
                                          float(t["sub_overdensity"]))
                       ) ** (1.0 / 3.0)
        sidx, soff, svel, _ = _plummer(
            torch.as_tensor(sub_sizes, device=device), dev64(rs / 2.5),
            dev64(sub_sizes * mdm), G, hgen, float(t["velocity_factor"]))
        parts_pos.append(dev64(sc)[sidx] + soff)
        parts_vel.append(dev64(sv)[sidx] + svel)
        halo_of = torch.cat([halo_of, torch.as_tensor(sub_host,
                                                      device=device)[sidx]])
        sub_of = torch.cat([sub_of, sidx])
    nh = sum(int(p.shape[0]) for p in parts_pos)
    nbg = ndm - nh
    # the per-particle arrays are built in place and permuted one at a
    # time, so that a volume of hundreds of millions of particles fits
    parts_pos.append(torch.rand(nbg, 3, generator=gen, device=device,
                                dtype=torch.float64).mul_(box))
    parts_vel.append(torch.randn(nbg, 3, generator=gen, device=device,
                                 dtype=torch.float64).mul_(
                                     float(t["background_sigma"])))
    halo_of = torch.cat([halo_of, torch.full((nbg,), -1, dtype=torch.int64,
                                             device=device)])
    sub_of = torch.cat([sub_of, torch.full((nbg,), -1, dtype=torch.int64,
                                           device=device)])
    pos = torch.cat(parts_pos).remainder_(box)
    del parts_pos
    vel = torch.cat(parts_vel)
    del parts_vel

    perm = torch.randperm(ndm, generator=gen, device=device)
    pos = pos[perm]
    vel = vel[perm]
    halo_of = halo_of[perm]
    sub_of = sub_of[perm]
    del perm
    mass = torch.full((ndm,), mdm, dtype=torch.float64, device=device)
    if "gas" not in cfg["species"]:
        return Snapshot(pos=_f32(pos, box), vel=vel.float(),
                        mass=mass.float(), boxsize=box, a=a,
                        sub_of=sub_of, sub_sizes=sub_sizes,
                        sub_host=sub_host, halo_sizes=sizes)
    return _with_gas(cfg, t, e, pos, vel, mass, halo_of, sub_of, sizes,
                     rt, masses["gas"], box, d_mean, a, gen, sub_sizes,
                     sub_host)


def _f32(pos: torch.Tensor, box: float) -> torch.Tensor:
    """float32 positions in [0, box) (a value that rounds up to the box
    edge wraps to 0)."""
    p = pos.float()
    return torch.where(p >= box, p - box, p)


def _with_gas(cfg, t, e, pos, vel, mass, halo_of, sub_of, sizes, rt, mgas,
              box, d_mean, a, gen, sub_sizes, sub_host) -> Snapshot:
    """One gas particle per dark-matter particle at the EAGLE offset
    (half a cell along the diagonal), scaled inside a halo by its radius
    over its Lagrangian radius; stars and hydro fields."""
    dev = pos.device
    ndm = pos.shape[0]
    inh = halo_of >= 0
    h = torch.clamp_min(halo_of, 0)
    rt_t = torch.as_tensor(rt, device=dev)
    size_t = torch.as_tensor(sizes, device=dev, dtype=torch.float64)
    rlag = d_mean * (3.0 * size_t / (4.0 * math.pi)) ** (1.0 / 3.0)
    shrink = torch.where(inh, rt_t[h] / rlag[h], 1.0)
    gpos = torch.remainder(pos + (0.5 * d_mean) * shrink[:, None], box)
    # thermal scatter of the halo gas about its dark-matter particle
    sig_h = torch.as_tensor(np.sqrt(e["Gravity"] * sizes * mass[0].item() /
                                    (6.0 * rt / 2.5)), device=dev)
    gvel = vel + torch.randn(ndm, 3, generator=gen, device=dev,
                             dtype=torch.float64) * \
        torch.where(inh, float(t["gas_sigma_share"]) * sig_h[h],
                    0.0)[:, None]
    # stars: star_share of the gas of each halo of star_min_halo or more
    big = inh & (size_t[h] >= float(t["star_min_halo"]))
    key = torch.rand(ndm, generator=gen, device=dev, dtype=torch.float64)
    order = torch.argsort(torch.where(big, h.double(), -1.0) * 2.0 + key)
    hs = torch.where(big, h, -1)[order]
    first = torch.searchsorted(hs, hs, right=False)
    rank = torch.arange(ndm, device=dev) - first
    nstar = torch.floor(float(t["star_share"]) * size_t).long()
    is_star = torch.zeros(ndm, dtype=torch.bool, device=dev)
    is_star[order] = (hs >= 0) & (rank < nstar[torch.clamp_min(hs, 0)])
    # hydro fields (assumed values, listed in the traffic file)
    u = torch.where(inh, 1.5 * (sig_h[h] ** 2),
                    float(t["u_background"]))
    zmet = torch.where(inh, float(t["zmet_halo"]), 0.0)
    sfr = torch.where(inh & (size_t[h] >= float(t["star_min_halo"])),
                      float(t["sfr_halo"]), 0.0)
    tage = torch.where(is_star,
                       float(t["tage_min"]) + (float(t["tage_max"]) -
                                               float(t["tage_min"])) *
                       torch.rand(ndm, generator=gen, device=dev,
                                  dtype=torch.float64), 0.0)
    gas, star = ~is_star, is_star
    ng, ns = int(gas.sum()), int(star.sum())
    pos_all = torch.cat([gpos[gas], pos, gpos[star]])
    vel_all = torch.cat([gvel[gas], vel, gvel[star]])
    mass_all = torch.cat([torch.full((ng,), mgas, dtype=torch.float64,
                                     device=dev), mass,
                          torch.full((ns,), mgas, dtype=torch.float64,
                                     device=dev)])
    ptype = torch.cat([torch.full((ng,), GAS, dtype=torch.int8, device=dev),
                       torch.full((ndm,), DARK, dtype=torch.int8,
                                  device=dev),
                       torch.full((ns,), STAR, dtype=torch.int8,
                                  device=dev)])
    zeros = torch.zeros(ndm, dtype=torch.float64, device=dev)
    extras = {
        "u": torch.cat([u[gas], zeros, zeros[star]]),
        "sfr": torch.cat([sfr[gas], zeros, zeros[star]]),
        "zmet": torch.cat([zmet[gas], zeros, zmet[star]]),
        "tage": torch.cat([zeros[gas], zeros, tage[star]]),
    }
    sub_all = torch.cat([torch.full((ng,), -1, dtype=torch.int64,
                                    device=dev), sub_of,
                         torch.full((ns,), -1, dtype=torch.int64,
                                    device=dev)])
    return Snapshot(pos=_f32(pos_all, box), vel=vel_all.float(),
                    mass=mass_all.float(), boxsize=box, a=a, ptype=ptype,
                    extras={k: v.float() for k, v in extras.items()},
                    sub_of=sub_all, sub_sizes=sub_sizes, sub_host=sub_host,
                    halo_sizes=sizes)
