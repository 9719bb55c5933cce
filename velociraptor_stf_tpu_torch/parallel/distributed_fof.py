"""FOF over a mesh: x-slabs of the periodic box with ghost exchange (port
of velociraptor_stf_tpu/parallel/distributed_fof.py), the analog of the
reference's distributed FOF (mpiroutines.cxx:49-2968) and its link-across
fixed point (search.cxx:292-347).

* ``SlabPlan``: a grid of cells at least the reach wide over the box; its
  ``nx`` x-columns are cut into ``ndev`` slabs of ``W`` columns, and each
  particle goes to the shard of its slab (original order within a shard).
  The host sees the per-shard loads.
* Each shard receives, from its two ring neighbours, copies of the
  particles of their boundary columns (``collectives.ppermute``): its
  ghost columns, one cell wide.  It bins its particles and ghosts on the
  local grid of W + 2 columns (x clipped, y and z periodic) and finds its
  local components once, with the port's pair pipeline
  (``ops/fof.py``: ``stencil_windows``, ``cell_pairs``,
  ``fof_labels_from_edges``).
* The cross-slab fixed point then iterates on labels only: every
  component takes the lowest global id of its members, the boundary
  particles' labels refresh their ghost copies on the neighbours, and the
  psum of the changed labels ends the loop.
* The converged labels (each particle's component's lowest original
  index) come back to the home device and are renumbered by size as on
  one device.

Distances are rounded as the single-device sweep rounds them: against
the neighbour's periodic image (``image_d2``); the 6D criterion is the
sweep kernel's,
d2 * (1 / ell^2) + dv2 * (1 / vscale2) <= 1 within one nonzero 3DFOF
group, with the velocities, scales and groups riding the same ghost
exchange.  The reference's cap of 256 cells per dimension sized its dense
prefix table and is not carried over: the port's windows are binary
searches, so cells stay the reach wide.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..kernels._common import cell_pairs
from ..models import halos
from ..ops.cells import CellGrid, build_grid
from ..ops.fof import fof_labels_from_edges, stencil_windows
from ..ops.fof_sweep import renumber_roots
from ..ops import segments as seg
from ..utils import telemetry
from ..utils.transfer import fetch_small
from . import collectives as col
from .mesh import Mesh

_BIG = torch.iinfo(torch.int32).max     # above every global id


class SlabPlan:
    """The x-slab decomposition of one snapshot: which particles each
    shard holds, and their positions and global ids there."""

    def __init__(self, pos: torch.Tensor, reach: float, boxsize: float,
                 mesh: Mesh):
        ndev = mesh.size
        self.mesh = mesh
        self.n = int(pos.shape[0])
        self.boxsize = float(boxsize)
        g = build_grid(np.zeros(3), np.full(3, self.boxsize), reach,
                       periodic=True, boxsize=self.boxsize)
        nx_max, self.ny, self.nz = g.ncells
        if nx_max < ndev:
            raise ValueError(f"a box of {nx_max} cells of width >= {reach} "
                             f"cannot be cut into {ndev} slabs")
        self.W = nx_max // ndev
        self.nx = self.W * ndev
        self.width = (self.boxsize / self.nx, self.boxsize / self.ny,
                      self.boxsize / self.nz)
        dev = torch.div(self.cells(pos)[:, 0], self.W, rounding_mode="floor")
        order = torch.argsort(dev, stable=True)
        self.load = fetch_small(torch.bincount(dev, minlength=ndev))
        for s, k in enumerate(self.load):
            telemetry.count(f"mesh_slab_load::"
                            f"{col.current_stage() or 'slabplan'}::shard{s}",
                            k)
        starts = np.concatenate([[0], np.cumsum(self.load)])
        self.idx = [order[starts[s]:starts[s + 1]] for s in range(ndev)]
        self.pos_b = self.pack(pos)
        self.gid_b = self.pack(torch.arange(self.n, dtype=torch.int32,
                                            device=pos.device))

    def cells(self, p: torch.Tensor) -> torch.Tensor:
        """(m, 3) int64 global cell coordinates of positions ``p``."""
        w = torch.tensor(self.width, dtype=p.dtype, device=p.device)
        nc = torch.tensor((self.nx, self.ny, self.nz), device=p.device)
        return torch.remainder(torch.floor(p / w).long(), nc)

    def pack(self, arr: torch.Tensor) -> List[torch.Tensor]:
        """Per-particle ``arr`` (home device) as the shards' blocks."""
        out = [col.move(arr[i], d)
               for i, d in zip(self.idx, self.mesh.devices)]
        col.count_reshard(col.current_stage() or "slabplan", out)
        return out

    def unpack(self, blocks: List[torch.Tensor]) -> torch.Tensor:
        """The shards' blocks back into one array in original order."""
        home = self.mesh.home
        out = torch.empty((self.n,) + tuple(blocks[0].shape[1:]),
                          dtype=blocks[0].dtype, device=home)
        for i, b in zip(self.idx, blocks):
            out[i] = col.move(b, home)
        col.count_reshard(col.current_stage() or "slabplan", blocks)
        return out

    def with_ghosts(self, fields: List[List[torch.Tensor]],
                    keep: Optional[List[torch.Tensor]] = None,
                    travel: Optional[List[torch.Tensor]] = None):
        """Each shard's particles (those of ``keep``, default all) with
        copies of its neighbours' boundary particles appended.
        ``fields``: per shard, a list of per-particle tensors, positions
        first; ``travel``: per shard, the particles that may be copied
        (default the kept ones).  Returns per shard (sel, sendL, sendR,
        payload): the kept particles, the indices among them of the left-
        and right-column ones that travel, and the fields as [kept | left
        ghosts | right ghosts]."""
        mesh, W = self.mesh, self.W
        sels, sendL, sendR, own = [], [], [], []
        for s, f in enumerate(fields):
            sel = torch.arange(f[0].shape[0], device=f[0].device) \
                if keep is None else torch.nonzero(keep[s]).squeeze(1)
            f = [x[sel] for x in f]
            xrel = self.cells(f[0])[:, 0] - s * W
            if travel is not None:
                xrel = torch.where(travel[s][sel], xrel, -1)
            sels.append(sel)
            own.append(f)
            sendL.append(torch.nonzero(xrel == 0).squeeze(1))
            sendR.append(torch.nonzero(xrel == W - 1).squeeze(1))
        out = [list(f) for f in own]
        for k in range(len(own[0])):
            # left ghosts = the left neighbour's right column, and back
            fromL = col.ppermute(mesh, [f[k][i] for f, i in
                                        zip(own, sendR)], col.ring(mesh, 1))
            fromR = col.ppermute(mesh, [f[k][i] for f, i in
                                        zip(own, sendL)], col.ring(mesh, -1))
            for s in range(mesh.size):
                out[s][k] = torch.cat([own[s][k], fromL[s], fromR[s]])
        return [(sels[s], sendL[s], sendR[s], out[s])
                for s in range(mesh.size)]

    def local_sort(self, s: int, cpos: torch.Tensor):
        """(order, cid_sorted, grid): shard ``s``'s particles and ghosts
        sorted by their cell on the local grid of W + 2 columns (ghost
        columns 0 and W + 1)."""
        c = self.cells(cpos)
        xrel = torch.remainder(c[:, 0] - s * self.W + 1, self.nx)
        cid = (xrel * self.ny + c[:, 1]) * self.nz + c[:, 2]
        order = torch.argsort(cid, stable=True)
        grid = CellGrid((self.W + 2, self.ny, self.nz), (0.0, 0.0, 0.0),
                        self.width)
        return order, cid[order], grid


def image_d2(a: torch.Tensor, b: torch.Tensor, boxsize: float
             ) -> torch.Tensor:
    """Squared separation of (m, 3) position pairs as the single-device
    sweep rounds it (``ops/fof_sweep.py``: the neighbour's periodic ghost
    image, shifted by +-boxsize along each axis it wraps, subtracted from
    the row's position): the smaller of the two orientations' values,
    since a pair links when either row finds the other's image.  The
    minimum image ``d - L round(d / L)`` rounds a wrapped pair's
    separation differently, by an ulp of the box."""
    box = torch.tensor(boxsize, dtype=a.dtype, device=a.device)
    k = torch.round((a - b) / box)
    d_ab = a - (b + k * box)
    d_ba = b - (a - k * box)
    return torch.minimum(seg.sq3(d_ab), seg.sq3(d_ba))


def _local_edges(pos_s: torch.Tensor, cid_s: torch.Tensor, grid: CellGrid,
                 boxsize: float, pred) -> Tuple[torch.Tensor, torch.Tensor,
                                                int]:
    """Links (each pair once) among one shard's cell-sorted particles and
    ghosts, and the candidate pairs enumerated."""
    cell, win = stencil_windows(cid_s, cid_s, grid, True, clip_x=True)
    erows, ecols, cand = [], [], 0
    for row, c in cell_pairs(cell, win):
        cand += int(row.shape[0])
        fwd = c > row
        row, c = row[fwd], c[fwd]
        ok = pred(image_d2(pos_s[row], pos_s[c], boxsize), row, c)
        erows.append(row[ok])
        ecols.append(c[ok])
    empty = torch.zeros(0, dtype=torch.int64, device=pos_s.device)
    return (torch.cat(erows) if erows else empty,
            torch.cat(ecols) if ecols else empty, cand)


def distributed_fof3d(pos: torch.Tensor, linking_length: float,
                      boxsize: float, mesh: Mesh, min_size: int = 8,
                      max_outer: int = 64, vel=None, vscale2=None,
                      group=None, plan: Optional[SlabPlan] = None
                      ) -> Tuple[torch.Tensor, int]:
    """FOF of a periodic box over the mesh: (pfof int64 on the home
    device in original order, ids 1..ng by decreasing size as
    ``SweepFof.fof3d``; ng).  With ``vel``, ``vscale2`` and ``group`` the
    links are 6D within one nonzero ``group`` (``SweepFof.fof6d``).
    ``plan``: a ``SlabPlan`` with cells at least ``linking_length``
    wide."""
    sixd = vel is not None
    with col.audit_stage("fof6d" if sixd else "fof3d"):
        if plan is None:
            plan = SlabPlan(pos, linking_length, boxsize, mesh)
        return _fof(plan, linking_length, min_size, max_outer, vel,
                    vscale2, group)


def _fof(plan: SlabPlan, linking_length: float, min_size: int,
         max_outer: int, vel, vscale2, group) -> Tuple[torch.Tensor, int]:
    mesh = plan.mesh
    if min(plan.width) < linking_length * (1 - 1e-9):
        raise ValueError("SlabPlan cells narrower than the linking length")
    n, ndev = plan.n, mesh.size
    sixd = vel is not None
    stage = "fof6d" if sixd else "fof3d"
    b2 = float(linking_length) ** 2
    fields = [[p, g] for p, g in zip(plan.pos_b, plan.gid_b)]
    keep = None
    if sixd:
        rivs = 1.0 / torch.clamp_min(vscale2.float(), 1e-30)
        for f, v, r, g in zip(fields, plan.pack(vel.float()),
                              plan.pack(rivs), plan.pack(group.int())):
            f += [v, r, g]
        # only 3DFOF members can link
        keep = [f[4] > 0 for f in fields]
    shards = plan.with_ghosts(fields, keep)

    inv_b2 = float(np.float32(1.0 / b2))
    states = []
    for s, (sel, sendL, sendR, cf) in enumerate(shards):
        order, cid_s, grid = plan.local_sort(s, cf[0])
        pos_s = cf[0][order]
        if sixd:
            v_s, r_s, g_s = (cf[k][order] for k in (2, 3, 4))

            def pred(d2, row, c):
                same = (g_s[row] > 0) & (g_s[row] == g_s[c])
                phase = d2 * inv_b2 + seg.sq3(v_s[row] - v_s[c]) * r_s[row]
                return same & (phase <= 1.0)
        else:
            def pred(d2, row, c):
                return d2 <= b2
        erow, ecol, cand = _local_edges(pos_s, cid_s, grid, plan.boxsize,
                                        pred)
        telemetry.count(f"mesh_candidates::{stage}::shard{s}", cand)
        nslot = int(order.shape[0])
        inv = torch.empty_like(order)
        inv[order] = torch.arange(nslot, device=order.device)
        m = int(sel.shape[0])
        nL = int(shards[(s - 1) % ndev][2].shape[0])
        states.append(dict(
            lab=fof_labels_from_edges(erow, ecol, nslot, undirected=True),
            glab=cf[1][order], inv=inv, m=m, gL=inv[m:m + nL],
            gR=inv[m + nL:], sL=inv[sendL], sR=inv[sendR]))

    def comp_min(st):
        comp = torch.full_like(st["glab"], _BIG).scatter_reduce_(
            0, st["lab"], st["glab"], "amin")
        return torch.minimum(st["glab"], comp[st["lab"]])

    for rnd in range(max_outer + 1):
        new = [comp_min(st) for st in states]
        fromL = col.ppermute(mesh, [g[st["sR"]] for g, st in
                                    zip(new, states)], col.ring(mesh, 1))
        fromR = col.ppermute(mesh, [g[st["sL"]] for g, st in
                                    zip(new, states)], col.ring(mesh, -1))
        changed = []
        for s, st in enumerate(states):
            g = new[s]
            g[st["gL"]] = torch.minimum(g[st["gL"]], fromL[s])
            g[st["gR"]] = torch.minimum(g[st["gR"]], fromR[s])
            changed.append((g != st["glab"]).sum())
            st["glab"] = g
        if int(fetch_small(col.psum(mesh, changed)[0])) == 0:
            break
    else:
        raise RuntimeError(f"cross-slab labels did not converge in "
                           f"{max_outer} rounds")
    telemetry.count(f"{stage}_outer_rounds", rnd + 1)
    # every particle's label: its component's lowest original index (its
    # own where it did not take part)
    blocks = []
    for gid_l, st, (sel, _, _, _) in zip(plan.gid_b, states, shards):
        lab = gid_l.clone()
        lab[sel] = comp_min(st)[st["inv"][:st["m"]]]
        blocks.append(lab)
    raw = plan.unpack(blocks)
    sub = torch.nonzero(group > 0).squeeze(1) if sixd else \
        torch.arange(n, device=raw.device)
    gid, ng = renumber_roots(raw[sub].long(), sub, n, min_size)
    pfof = torch.zeros(n, dtype=torch.int64, device=raw.device)
    pfof[sub] = gid
    return pfof, ng


@col.staged("fof6d")
def velocity_scales_sharded(plan: SlabPlan, vel: torch.Tensor,
                            mass: torch.Tensor, pfof3: torch.Tensor,
                            ng3: int) -> torch.Tensor:
    """(ng3+1,) float32 mass-weighted velocity dispersion^2 of every 3DFOF
    group, on the home device: the shards' float64 partial sums
    (``halos.group_moments`` / ``group_spread``) combined by psum, the
    analog of the reference's MPI_Allreduce over group bulk quantities
    (search.cxx:443-499); ``halos.group_dispersion2`` on one device."""
    mesh = plan.mesh
    ng1 = ng3 + 1
    g_b = plan.pack(pfof3.int())
    m_b = plan.pack(mass)
    v_b = plan.pack(vel)
    tot = col.psum(mesh, [halos.group_moments(v, m, g, ng1)
                          for v, m, g in zip(v_b, m_b, g_b)])
    msum, vmean = halos.mean_from_moments(tot[0])
    s2 = col.psum(mesh, [halos.group_spread(v, m, g, col.move(vmean,
                                                               v.device), ng1)
                         for v, m, g in zip(v_b, m_b, g_b)])[0]
    return col.move((s2 / col.move(msum, s2.device)).float(), mesh.home)


def distributed_fof6d(pos: torch.Tensor, vel: torch.Tensor,
                      mass: torch.Tensor, linking_length: float,
                      ell6dxfac: float, ell6dvfac: float, boxsize: float,
                      mesh: Mesh, min_size: int = 8, adaptive: bool = True
                      ) -> Tuple[torch.Tensor, int, torch.Tensor, int]:
    """3DFOF, then 6DFOF within its groups, over the mesh: (pfof6, ng6,
    pfof3, ng3) on the home device.  One plan serves both passes (cells
    at least max(ell3, ell6) wide); the velocity scale is each group's
    dispersion (``adaptive``) or group 1's."""
    plan = SlabPlan(pos, linking_length * max(1.0, ell6dxfac), boxsize,
                    mesh)
    pfof3, ng3 = distributed_fof3d(pos, linking_length, boxsize, mesh,
                                   min_size=min_size, plan=plan)
    if ng3 == 0:
        return pfof3, 0, pfof3, 0
    sig2 = velocity_scales_sharded(plan, vel, mass, pfof3, ng3)
    if not adaptive:
        sig2 = torch.full_like(sig2, float(fetch_small(sig2[1])))
    vscale2 = torch.where(
        pfof3 > 0, torch.clamp_min(sig2[pfof3] * ell6dvfac ** 2, 1e-30), 1.0)
    pfof6, ng6 = distributed_fof3d(
        pos, linking_length * ell6dxfac, boxsize, mesh, min_size=min_size,
        vel=vel, vscale2=vscale2, group=pfof3, plan=plan)
    return pfof6, ng6, pfof3, ng3
