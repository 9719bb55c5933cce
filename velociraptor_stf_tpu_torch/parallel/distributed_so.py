"""Spherical overdensities from all particles over a mesh (port of
velociraptor_stf_tpu/parallel/distributed_so.py), the analog of the
reference's halo-region import for SO searches (mpiroutines.cxx:
1723-2165) without moving a particle.

Halo centres and search radii are few and shared by every shard.  Each
shard bins its own block of particles on the class's cell grid (the
geometry does not depend on the shard) and builds partial
(halo, log-radius bin) mass and count histograms with
``ops/so.py::_class_histogram`` (float64 masses, exact for equal masses);
one psum combines them, and
``_so_crossings`` finds the crossings on the sum.  Blocks are contiguous
runs of the particle array, exact in size: there is no padding row.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import so
from ..ops.cells import bin_particles, build_grid
from ..utils.transfer import fetch_small
from . import collectives as col
from .distributed_props import chunks
from .mesh import Mesh


@col.staged("so")
def distributed_so_masses(pos: torch.Tensor, mass: torch.Tensor, centers,
                          rsearch, lnrho_thresholds, mesh: Mesh,
                          boxsize: Optional[float] = None, nbins: int = 128,
                          umin: float = 3e-3, minnum=None, first_mass=None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """``ops/so.py::so_masses_all_particles`` with the particles (on the
    home device) cut into shard blocks: (M, R) float64 numpy (H, nthr)."""
    centers = np.asarray(centers)
    rsearch = np.asarray(rsearch, np.float64)
    H = centers.shape[0]
    nthr = len(lnrho_thresholds)
    M_out = np.zeros((H, nthr), np.float64)
    R_out = np.zeros((H, nthr), np.float64)
    if H == 0:
        return M_out, R_out
    minnum = np.full(H, 1, np.int64) if minnum is None else \
        np.asarray(minnum)
    first_mass = np.zeros(H) if first_mass is None else \
        np.asarray(first_mass)
    if boxsize:
        glo, ghi = np.zeros(3), np.full(3, float(boxsize))
    else:
        glo, ghi = (np.asarray(v, np.float64) for v in fetch_small(
            [pos.amin(0), pos.amax(0)]))
    blocks = chunks(mesh, "so", pos, mass)
    home = mesh.home
    rs_max = float(rsearch.max())
    cls_of = np.maximum(0, np.ceil(np.log2(np.maximum(
        rs_max / np.maximum(rsearch, 1e-30), 1.0))).astype(int))
    lnumin = float(math.log(umin))
    for c in np.unique(cls_of):
        sel = np.where(cls_of == c)[0]
        grid = build_grid(glo, ghi, rs_max / (1 << int(c)),
                          periodic=bool(boxsize), boxsize=boxsize or 0.0,
                          max_total_cells=so._GRID_CELLS)
        parts_m, parts_n = [], []
        for p, m in blocks:
            order, cid_sorted = bin_particles(p, grid, bool(boxsize))
            ctr = torch.tensor(centers[sel], dtype=p.dtype, device=p.device)
            rs = torch.tensor(rsearch[sel], dtype=p.dtype, device=p.device)
            Mh, Nh = so._class_histogram(p[order], m[order], ctr, rs,
                                         cid_sorted, grid, boxsize, nbins,
                                         lnumin)
            parts_m.append(Mh)
            parts_n.append(Nh)
        Mh = col.psum(mesh, parts_m)[0].to(pos.dtype)
        Nh = col.psum(mesh, parts_n)[0]
        M, R = so._so_crossings(
            Mh, Nh, torch.tensor(rsearch[sel], dtype=pos.dtype, device=home),
            torch.tensor(np.asarray(lnrho_thresholds, np.float64),
                         dtype=pos.dtype, device=home),
            torch.tensor(minnum[sel], dtype=torch.int64, device=home),
            torch.tensor(first_mass[sel], dtype=pos.dtype, device=home),
            nbins, lnumin)
        M_out[sel], R_out[sel] = (np.asarray(v, np.float64)
                                  for v in fetch_small([M, R]))
    return M_out, R_out
