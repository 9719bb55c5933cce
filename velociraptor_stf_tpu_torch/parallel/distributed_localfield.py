"""Local velocity density over a mesh (port of
velociraptor_stf_tpu/parallel/distributed_localfield.py), the analog of
the reference's kNN import for ``GetVelocityDensity``
(mpiroutines.cxx:1203-1722).

The active particles are cut into ``ndev`` x-slabs, one per shard, on the
device: the home device sorts them by slab and each shard takes its run.
Each shard splits its slab into KD leaves
(``ops/kdgrid.py::median_partition``), receives the whole leaf blocks of
its two ring neighbours (``collectives.ppermute``; across the periodic
wrap their x is shifted by the box), and evaluates the same
``models/localfield.py::_leaf_densities`` for its own leaves against its
own and the neighbours' leaves.  Only the leaf decomposition differs from
one device (slab-local splits), which moves the approximative mode's
shared candidate sets near slab boundaries: the result agrees with the
single-device density statistically, not bit for bit.  A slab must hold
more than a neighbour ball, true at the sizes that shard
(``DIST_DENSITY_MIN`` active particles, the JAX package's default).  The
exact mode is never sharded.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..models.localfield import _BLOCK, _leaf_densities
from ..ops.kdgrid import median_partition
from ..utils.transfer import fetch_small
from . import collectives as col
from .mesh import Mesh

# active particles from which the recursion's density is sharded
DIST_DENSITY_MIN = 1 << 23


def _leaves(p, v, count: int, npad: int, leaf_size: int):
    """A shard's ``count`` particles (padded to ``npad`` rows parked far
    away) as KD leaves: (P, V, ok, cm_sel, pad_idx)."""
    dev = p.device
    nleaf = npad // leaf_size
    ok = torch.arange(npad, device=dev) < count
    p = torch.cat([p, p.new_zeros(npad - count, 3)])
    v = torch.cat([v, v.new_zeros(npad - count, 3)])
    if count:
        lo, hi = p[:count].amin(0), p[:count].amax(0)
    else:
        lo, hi = p.new_zeros(3), p.new_ones(3)
    span = torch.clamp_min(torch.amax(hi - lo), 1.0)
    far = hi[None, :] + span * (2.0 + torch.arange(
        npad, dtype=p.dtype, device=dev))[:, None]
    p = torch.where(ok[:, None], p, far)
    levels = int(math.log2(nleaf)) if nleaf > 1 else 0
    pad_idx = median_partition(p, levels, active=ok)
    P = p[pad_idx].reshape(nleaf, leaf_size, 3)
    V = v[pad_idx].reshape(nleaf, leaf_size, 3)
    okl = ok[pad_idx].reshape(nleaf, leaf_size)
    wsum = torch.clamp_min(okl.sum(1), 1)[:, None].to(p.dtype)
    cm = torch.where(okl[..., None], P, 0.0).sum(1) / wsum
    cm_sel = torch.where(
        okl.any(1)[:, None], cm,
        hi[None, :] + span * 1e3 * (1 + torch.arange(
            nleaf, dtype=p.dtype, device=dev))[:, None])
    return P, V, okl, cm_sel, pad_idx


@col.staged("density")
def distributed_velocity_density(pos: torch.Tensor, vel: torch.Tensor,
                                 mesh: Mesh, nvel: int = 32,
                                 nsearch: int = 256, leaf_size: int = 32,
                                 active: Optional[torch.Tensor] = None,
                                 boxsize: Optional[float] = None
                                 ) -> torch.Tensor:
    """(N,) approximative local velocity density of the ``active``
    particles (0 elsewhere), on the home device, with the particles
    sharded as x-slabs; the contract of
    ``models/localfield.py::velocity_density``."""
    ndev = mesh.size
    n = int(pos.shape[0])
    aidx = torch.arange(n, device=pos.device) if active is None else \
        torch.nonzero(active).squeeze(1)
    x = pos[aidx, 0]
    if boxsize:
        slab = torch.floor(x / boxsize * ndev)
    else:
        lo, hi = (float(v) for v in fetch_small([x.amin(), x.amax()]))
        slab = torch.floor((x - lo) / max(hi - lo, 1e-30) * ndev)
    slab = torch.clamp(slab.long(), 0, ndev - 1)
    order = torch.argsort(slab, stable=True)
    counts = fetch_small(torch.bincount(slab, minlength=ndev))
    starts = np.concatenate([[0], np.cumsum(counts)])
    npad = 1 << int(math.ceil(math.log2(max(int(counts.max()), leaf_size,
                                            nsearch))))
    nleaf = npad // leaf_size
    m = max(2, int(np.ceil(1.5 * nsearch / leaf_size)))
    m = min(m, nleaf * (3 if ndev > 1 else 1))
    nsearch = min(nsearch, m * leaf_size)
    nvel = min(nvel, nsearch - 1)

    rows = [aidx[order[starts[s]:starts[s + 1]]] for s in range(ndev)]
    pos_b = [col.move(pos[r], d) for r, d in zip(rows, mesh.devices)]
    vel_b = [col.move(vel[r], d) for r, d in zip(rows, mesh.devices)]
    col.count_reshard("density", pos_b + vel_b)
    leaves = [_leaves(p, v, int(c), npad, leaf_size)
              for p, v, c in zip(pos_b, vel_b, counts)]

    def ghosts(step: int, wrap_shard: int, shift: float):
        """The neighbours' leaf blocks (P, V, ok, cm) from ``step``; the
        shard ``wrap_shard`` receives across the ring's wrap."""
        got = [col.ppermute(mesh, [lv[k] for lv in leaves],
                            col.ring(mesh, step)) for k in range(4)]
        out = []
        for s in range(ndev):
            P, V, ok, cm = (g[s] for g in got)
            if s == wrap_shard and ndev > 1:
                if boxsize:
                    P = P.clone()
                    P[:, :, 0] += torch.where(ok, shift, 0.0)
                    cm = cm.clone()
                    cm[:, 0] += shift
                else:
                    # an open domain does not wrap: nothing to import
                    ok = torch.zeros_like(ok)
                    cm = torch.full_like(cm, math.inf)
            out.append((P, V, ok, cm))
        return out

    box = float(boxsize or 0.0)
    fromL = ghosts(1, 0, -box)
    fromR = ghosts(-1, ndev - 1, box)
    dens = torch.zeros(n, dtype=pos.dtype, device=mesh.home)
    for s, (P, V, ok, cm, pad_idx) in enumerate(leaves):
        if ndev > 1:
            pool = tuple(torch.cat(abc) for abc in
                         zip((P, V, ok, cm), fromL[s], fromR[s]))
        else:
            pool = (P, V, ok, cm)
        chunk = max(1, min(2048, _BLOCK // int(pool[0].shape[0])))
        d = _leaf_densities(P, V, ok, cm, nvel, nsearch, m, chunk, False,
                            pool=pool)
        okf = ok.reshape(-1)
        loc = torch.zeros(npad, dtype=pos.dtype, device=P.device)
        loc[pad_idx[okf]] = d.reshape(-1)[okf]
        dens[rows[s]] = col.move(loc[:int(counts[s])], mesh.home)
    col.count_reshard("density", [dens])
    return dens
