"""Gravitational unbinding (port of velociraptor_stf_tpu/models/unbind.py:
``compute_potential``, ``check_unbound_groups``, the ejection loop and
``_finalize_unbind``).

Semantics (reference unbind.cxx:196-1199):

* a particle is bound when Eratio * T + W < 0, with T its kinetic energy in
  the group's reference frame and W its potential energy in the group;
* per iteration at most ``maxunbindfrac`` of a group's bound particles are
  ejected, least bound first (ties in index order);
* reference frame: CMVELREF = the CM velocity of the bound members, carried
  as per-group sums from which each iteration subtracts the dropped
  particles; POTREF = the mean velocity of the ``Npotref`` (or
  ``fracpotref``) most bound-by-potential members, fixed;
* groups below MinSize dissolve; with USYSANDPART groups whose bound mass
  fraction is below ``minEfrac`` dissolve;
* ``Keep_background_potential=0`` recomputes the potential of the groups
  that lost members, from their bound survivors, every ``CHUNK_ITERS``
  iterations;
* surviving groups are renumbered by decreasing size.

The loop runs on the tagged particles, sorted by group (stable).  It keeps
the reference's schedule where that schedule changes float32 results: the
carried per-group sums are recomputed from scratch exactly where the
reference compacts its working set (its padded capacity decides when), so
the bound masks equal the reference's for the same W.  Arrays keep the
caller's float dtype; only the potential kernel works in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..ops import gravity, gravity_direct, segments as seg

from velociraptor_stf_tpu.utils.config import POTREF, USYSANDPART, UnbindInfo

CHUNK_ITERS = 4      # iterations between potential recomputes / compaction
MAX_CHUNKS = 64      # iteration cap: MAX_CHUNKS * CHUNK_ITERS
MAX_DIRECT = 1 << 20  # larger groups take the bucket tree (the reference's
                      # ops/pallas_gravity.py MAX_DIRECT)


@dataclass
class UnbindResult:
    pfof: torch.Tensor          # renumbered bound-group ids (original order)
    ngroups: int
    W: torch.Tensor             # potential energy per particle
    Efrac: torch.Tensor         # bound mass fraction per (old) group id
    bound: torch.Tensor         # bool mask of particles kept in groups
    gid_map: torch.Tensor       # old gid -> new gid (0 dissolved)


def compute_potential(pos: torch.Tensor, mass: torch.Tensor,
                      pfof: torch.Tensor, num_groups: int, eps: float,
                      G: float, boxsize: Optional[float] = None,
                      direct_cut: int = MAX_DIRECT) -> torch.Tensor:
    """(N,) potential energy W_i = m_i * Phi_i within each particle's
    group (0 for untagged).

    Groups of up to ``direct_cut`` members are summed exactly by the direct
    kernel; larger ones take the bucket tree (``ops/gravity.py``), batched
    by power-of-two size class with zero-mass copies of each group's last
    member as padding, as the reference does (its cut is ``MAX_DIRECT`` on
    a TPU and 4096 elsewhere).  The cut decides which groups are
    approximated, so it is part of the result."""
    if boxsize:
        pos = seg.unwrap_positions(pos, pfof, boxsize, num_groups)
    perm = seg.sort_by_group(pfof)
    g_s = pfof[perm]
    pos_s, mass_s = pos[perm], mass[perm]
    offsets = seg.group_offsets(g_s, num_groups)
    sizes = offsets[1:] - offsets[:-1]
    big = sizes > direct_cut
    big[0] = False
    big_ids = torch.nonzero(big).squeeze(1).tolist()
    gid_direct = torch.where(big[g_s], 0, g_s) if big_ids else g_s
    eps2 = float(eps * eps)
    phi = gravity_direct.potential_group_sorted(pos_s, mass_s, gid_direct,
                                                offsets, eps2)
    w_s = ((-G) * phi).to(pos.dtype)
    by_class: dict = {}
    sizes_h = sizes.tolist() if big_ids else []
    for g in big_ids:
        by_class.setdefault(1 << (sizes_h[g] - 1).bit_length(), []).append(g)
    for cpad, gs in sorted(by_class.items()):
        gs = torch.tensor(gs, device=pos.device)
        st, cnt = offsets[gs], sizes[gs]
        k = torch.arange(cpad, device=pos.device)
        idx = torch.minimum(st[:, None] + k[None, :], (st + cnt - 1)[:, None])
        valid = k[None, :] < cnt[:, None]
        wg = gravity.bucket_tree_potential_batch(
            pos_s[idx], torch.where(valid, mass_s[idx], 0.0), eps2, G,
            valid=valid)
        w_s[idx[valid]] = wg[valid].to(w_s.dtype)
    W = torch.zeros(pos.shape[0], dtype=pos.dtype, device=pos.device)
    W[perm] = w_s * mass_s
    return W


def check_unbound_groups(pos: torch.Tensor, vel: torch.Tensor,
                         mass: torch.Tensor, pfof: torch.Tensor,
                         num_groups: int, uinfo: UnbindInfo, G: float,
                         boxsize: Optional[float] = None,
                         min_size: int = 20,
                         W: Optional[torch.Tensor] = None) -> UnbindResult:
    """Compute potentials (unless ``W`` is given), eject unbound particles
    iteratively, dissolve and renumber groups (reference
    CheckUnboundGroups, unbind.cxx:196)."""
    n = pfof.shape[0]
    pfof = pfof.long()
    tagged = torch.nonzero(pfof > 0).squeeze(1)
    order = tagged[torch.argsort(pfof[tagged], stable=True)]
    ntag = int(order.shape[0])
    pos_t, vel_t, mass_t, pfof_t = pos[order], vel[order], mass[order], \
        pfof[order]
    if W is None:
        W_t = compute_potential(pos_t, mass_t, pfof_t, num_groups,
                                uinfo.eps, G, boxsize)
        W = torch.zeros(n, dtype=pos.dtype, device=pos.device)
        W[order] = W_t
    else:
        W_t = W[order]
    # the reference's working-set capacity: its tagged-subset class, or
    # the full array when most particles are tagged
    ncur = seg.pad_class(ntag) if 0 < ntag < n // 2 else n
    bound_t = eject(pos_t, vel_t, mass_t, pfof_t, W_t, num_groups, uinfo,
                    G, boxsize, min_size, ncur)
    bound = torch.zeros(n, dtype=torch.bool, device=pfof.device)
    bound[order] = bound_t
    return _finalize(pfof, bound, W, num_groups, uinfo, min_size,
                     (mass_t, pfof_t, bound_t))


def _group_stats(vel: torch.Tensor, mass: torch.Tensor, g: torch.Tensor,
                 sel: torch.Tensor, ng1: int) -> torch.Tensor:
    """(5, ng1) per-group sums [m vx, m vy, m vz, m, count] over ``sel``
    of group-sorted particles, each added in index order."""
    i = torch.nonzero(sel).squeeze(1)
    gi, w, v = g[i], mass[i], vel[i]
    return torch.stack([seg.segment_sum(row, gi, ng1, presorted=True)
                        for row in (w * v[:, 0], w * v[:, 1], w * v[:, 2],
                                    w, torch.ones_like(w))])


def _potref_velocity(vel: torch.Tensor, mass: torch.Tensor,
                     g: torch.Tensor, W: torch.Tensor, num_groups: int,
                     uinfo: UnbindInfo) -> torch.Tensor:
    """(ng1, 3) POTREF frame: mean velocity of each group's max(Npotref,
    fracpotref * size) lowest-potential members."""
    perm = torch.argsort(W, stable=True)
    perm = perm[torch.argsort(g[perm], stable=True)]
    g_s = g[perm]
    offsets = seg.group_offsets(g_s, num_groups)
    rank = seg.segment_rank(g_s, offsets)
    counts = (offsets[1:] - offsets[:-1]).to(torch.float32)
    npot = torch.clamp_min((uinfo.fracpotref * counts[g_s]).to(torch.int32),
                           uinfo.Npotref)
    selq = (rank < npot) & (g_s > 0)
    w = torch.where(selq, mass[perm], 0.0)
    return seg.segment_mean(vel[perm], w, g_s, num_groups + 1,
                            presorted=True)


def _eject_once(vel: torch.Tensor, mass: torch.Tensor, g: torch.Tensor,
                W: torch.Tensor, bound: torch.Tensor, stats: torch.Tensor,
                potref_vel: torch.Tensor, uinfo: UnbindInfo,
                min_size: int) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """One ejection iteration -> (bound, stats, any particle dropped)."""
    ng1 = stats.shape[1]
    dtype = mass.dtype
    if uinfo.cmvelreftype == POTREF:
        vref = potref_vel
    else:
        vref = (stats[0:3] / torch.clamp_min(stats[3:4], 1e-30)).T
    dvx = vel[:, 0] - vref[g, 0]
    dvy = vel[:, 1] - vref[g, 1]
    dvz = vel[:, 2] - vref[g, 2]
    T = 0.5 * mass * (dvx * dvx + dvy * dvy + dvz * dvz)
    E = torch.tensor(uinfo.Eratio, dtype=dtype, device=g.device) * T + W
    unbound = (E > 0) & bound
    nb = stats[4].to(torch.int32)
    frac = torch.tensor(uinfo.maxunbindfrac, dtype=dtype, device=g.device)
    cap = torch.clamp_min((frac * nb.to(dtype)).to(torch.int32), 1)
    exceed = torch.bincount(g[unbound], minlength=ng1) > cap
    remove = unbound
    if bool(exceed.any()):
        # groups over their cap drop only their cap highest-E particles
        cand = torch.nonzero(unbound & exceed[g]).squeeze(1)
        order = torch.argsort(-E[cand], stable=True)
        order = order[torch.argsort(g[cand][order], stable=True)]
        gs = g[cand][order]
        rank = torch.arange(gs.shape[0], device=g.device) - \
            torch.searchsorted(gs, gs)
        remove = unbound & ~exceed[g]
        remove[cand[order[rank < cap[gs]]]] = True
    remove = remove & bound
    nb2 = nb - torch.bincount(g[remove], minlength=ng1)
    dissolved = nb2 < min_size
    bound2 = bound & ~remove & ~dissolved[g]
    dropped = bound & ~bound2
    stats = stats - _group_stats(vel, mass, g, dropped, ng1)
    return bound2, stats, bool(dropped.any())


def eject(pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor,
          pfof: torch.Tensor, W: torch.Tensor, num_groups: int,
          uinfo: UnbindInfo, G: float, boxsize: Optional[float],
          min_size: int, ncur: int) -> torch.Tensor:
    """Iterative ejection over group-sorted particles -> bound mask.

    After every chunk of ``CHUNK_ITERS`` iterations that still dropped a
    particle, the groups that lost members are the only ones that can
    change again; with ``bgpot == 0`` their potential is recomputed from
    their bound members.  The working set shrinks to those groups' bound
    particles when they are at most 3/4 of the reference's capacity
    ``ncur``, and the per-group sums then start afresh."""
    ng1 = num_groups + 1
    if uinfo.cmvelreftype == POTREF:
        potref_vel = _potref_velocity(vel, mass, pfof, W, num_groups, uinfo)
    else:
        potref_vel = None
    bound_out = pfof > 0
    cur = torch.arange(pfof.shape[0], device=pfof.device)
    bound = bound_out.clone()
    prev_bound = bound
    stats = None
    for _ in range(MAX_CHUNKS):
        if stats is None:
            stats = _group_stats(vel, mass, pfof, bound, ng1)
        for _ in range(CHUNK_ITERS):
            bound, stats, changed = _eject_once(vel, mass, pfof, W, bound,
                                                stats, potref_vel, uinfo,
                                                min_size)
            if not changed:
                break
        bound_out[cur] = bound
        if not changed:
            break
        lost = torch.bincount(pfof[prev_bound & ~bound], minlength=ng1)
        active = (lost > 0)[pfof]
        if uinfo.bgpot == 0:
            W_new = compute_potential(pos, torch.where(bound, mass, 0.0),
                                      torch.where(active, pfof, 0),
                                      num_groups, uinfo.eps, G, boxsize)
            W = torch.where(active, W_new, W)
        sel = bound & active
        nsel = int(sel.sum())
        if 0 < nsel <= (3 * ncur) // 4:
            keep = torch.nonzero(sel).squeeze(1)
            cur, pos, vel, mass, pfof, W = (a[keep] for a in
                                            (cur, pos, vel, mass, pfof, W))
            ncur = seg.pad_class(nsel)
            bound = pfof > 0
            stats = None
        prev_bound = bound
    return bound_out


def _finalize(pfof: torch.Tensor, bound: torch.Tensor, W: torch.Tensor,
              num_groups: int, uinfo: UnbindInfo, min_size: int,
              subset: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
              ) -> UnbindResult:
    """Bound mass fractions, USYSANDPART dissolution, renumbering by size
    (ties by old gid).  ``subset`` = the tagged (mass, gid, bound) arrays,
    group-sorted, over which the per-group sums run."""
    ng1 = num_groups + 1
    m_t, g_t, b_t = subset
    mass0 = seg.segment_sum(m_t, g_t, ng1, presorted=True)
    mass1 = seg.segment_sum(torch.where(b_t, m_t, 0.0), g_t, ng1,
                            presorted=True)
    Efrac = mass1 / torch.clamp_min(mass0, 1e-30)
    if uinfo.unbindtype == USYSANDPART:
        ok = Efrac >= uinfo.minEfrac
        bound = bound & ok[pfof]
        b_t = b_t & ok[g_t]
    sizes = torch.bincount(g_t[b_t], minlength=ng1)
    gids = torch.arange(ng1, device=pfof.device)
    eligible = (sizes >= min_size) & (gids > 0)
    order = torch.argsort(-torch.where(eligible, sizes, 0), stable=True)
    ng_new = int(eligible.sum())
    gid_map = torch.zeros(ng1, dtype=torch.int64, device=pfof.device)
    gid_map[order] = torch.where(gids < ng_new, gids + 1, 0)
    pfof_new = gid_map[torch.where(bound, pfof, 0)]
    return UnbindResult(pfof=pfof_new, ngroups=ng_new, W=W, Efrac=Efrac,
                        bound=bound, gid_map=gid_map)


def sort_by_binding_energy(vel: torch.Tensor, mass: torch.Tensor,
                           pfof: torch.Tensor, W: torch.Tensor,
                           num_groups: int, gcmvel: torch.Tensor,
                           by_energy: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Reference SortAccordingtoBindingEnergy
    (substructureproperties.cxx:4256; key switch on
    ``Sort_by_binding_energy`` at :4308): the permutation ordering
    particles by group, most bound first within each (by energy, or by
    potential alone), and per group the index of the most bound particle
    and of the potential minimum (n for an empty group)."""
    ng1 = num_groups + 1
    dv = vel - gcmvel[pfof]
    E = 0.5 * mass * seg.sq3(dv) + W
    tagged = pfof > 0
    key = torch.where(tagged, E if by_energy else W, math.inf)
    perm = seg.lexsort2(key, pfof)
    mbp = seg.segment_argmin(torch.where(tagged, E, math.inf), pfof, ng1)
    minpot = seg.segment_argmin(torch.where(tagged, W, math.inf), pfof, ng1)
    return perm, mbp, minpot
