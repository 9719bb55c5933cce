"""Segmented moments of group-sorted rows: wrapper of
``csrc/segment_moments.cu`` and its plain PyTorch version.

``segment_moments`` replaces no Pallas kernel (the JAX package's property
stage is segment sums left to XLA).  It takes every sum of one dependent
pass of the property stage (``models/properties.py``) in one launch: for
each selection s and group g, the float64 sums over the group's rows in
the selection of the columns below, about the selection's centre c,
velocity reference u and rotation axis a of that group (dx = x - c,
dv = v - u, L = dx x dv):

  ``COUNT`` 1, ``M`` m, ``MX`` m x (3), ``MV`` m v (3), ``ML`` m L (3),
  ``MXX`` m dx_i dx_j (6: xx xy xz yy yz zz), ``MVV`` m dv_i dv_j (6),
  ``MV2`` m |dv|^2, ``KROT`` m/2 (L.a)^2 / max(|dx|^2 - (dx.a)^2, 1e-30),
  then per field j: ``BASE + 2 j`` the field, ``BASE + 2 j + 1`` m times it.

Inputs: ``rows`` (n, F) float32, x y z vx vy vz m then the fields, sorted
by group; ``offsets`` (ng1 + 1,) int64 group starts
(``ops/segments.py::group_offsets``); ``sel`` (n, S) bool; ``tabs`` (S, 3)
host integers, each selection's index into ``centre``, ``uvel`` and
``axis``, (T, ng1, 3) float64 tables.  Output (S, ng1, K) float64,
K = ``columns(nf)``.

The kernel forms the products and adds a group's rows in float64, in a
fixed order (one warp a selection and group, then a fixed shuffle tree).
The plain version adds each group's rows in index order
(``torch.segment_reduce``) in ``acc``: in float64 its products round as
the kernel's and only the order of the sums differs (``chip_smoke.py``
and the card tests hold the kernel to it); a CPU tensor takes it in the
rows' float32, the JAX package's sequential float32 scatter-add, so the
port's CPU path rounds as the reference does (the CPU tests hold it to
that package).  Either way a group's sums depend on its own rows only, so
two runs and a shard's block give the same bits.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import LAUNCHES
from ._build import check, load_library
from ._common import kernel_device, on_device, require, stream

COUNT, M, MX, MV, ML, MXX, MVV, MV2, KROT = 0, 1, 2, 5, 8, 11, 17, 23, 24
BASE = 25
MAX_FIELDS = 6
# selections a launch: their table indices travel in the launch's
# parameters (csrc/segment_moments.cu's VR_MOM_MAX_SEL)
MAX_SEL = 128


def columns(nf: int) -> int:
    """Columns of a pass over ``nf`` fields."""
    return BASE + 2 * nf


def row_columns(rows: torch.Tensor, nf: int, c: torch.Tensor,
                u: torch.Tensor, a: torch.Tensor,
                acc: torch.dtype = torch.float64) -> torch.Tensor:
    """(n, K) products in ``acc`` of each row about its (n, 3) centre,
    velocity reference and axis, in the kernel's order of operations
    (``torch.linalg.cross`` may fuse a multiply-add where the kernel does
    not: within an ulp of the float64 products)."""
    r = rows.to(acc)
    c, u, a = c.to(acc), u.to(acc), a.to(acc)
    x, v, m = r[:, 0:3], r[:, 3:6], r[:, 6]
    d, w = x - c, v - u
    L = torch.linalg.cross(d, w)
    mc = m[:, None]
    jz = L[:, 0] * a[:, 0] + L[:, 1] * a[:, 1] + L[:, 2] * a[:, 2]
    da = d[:, 0] * a[:, 0] + d[:, 1] * a[:, 1] + d[:, 2] * a[:, 2]
    rp2 = torch.clamp_min(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] +
                          d[:, 2] * d[:, 2] - da * da, 1e-30)
    pairs = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    cols = [torch.ones_like(m)[:, None], mc, mc * x, mc * v, mc * L,
            torch.stack([d[:, i] * d[:, j] * m for i, j in pairs], 1),
            torch.stack([w[:, i] * w[:, j] * m for i, j in pairs], 1),
            (m * (w[:, 0] * w[:, 0] + w[:, 1] * w[:, 1] +
                  w[:, 2] * w[:, 2]))[:, None],
            (0.5 * m * jz ** 2 / rp2)[:, None]]
    for j in range(nf):
        f = r[:, 7 + j]
        cols.append(torch.stack([f, m * f], 1))
    return torch.cat(cols, 1)


def segment_moments_ref(rows: torch.Tensor, nf: int, offsets: torch.Tensor,
                        sel: torch.Tensor, tabs: Sequence[Sequence[int]],
                        centre: torch.Tensor, uvel: torch.Tensor,
                        axis: torch.Tensor,
                        acc: torch.dtype = torch.float64) -> torch.Tensor:
    """The sums as float64, formed and added in ``acc``."""
    n = rows.shape[0]
    ng1 = offsets.shape[0] - 1
    g = torch.searchsorted(offsets, torch.arange(n, device=rows.device),
                           right=True) - 1
    g = torch.clamp(g, 0, ng1 - 1)
    lengths = offsets[1:] - offsets[:-1]
    out = []
    for s, (ci, ui, ai) in enumerate(tabs):
        vals = row_columns(rows, nf, centre[ci][g], uvel[ui][g],
                           axis[ai][g], acc)
        vals = torch.where(sel[:, s, None], vals, 0.0)
        out.append(torch.segment_reduce(vals, "sum", lengths=lengths,
                                        axis=0, unsafe=True).double())
    if not out:
        return torch.zeros(0, ng1, columns(nf), dtype=torch.float64,
                           device=rows.device)
    return torch.stack(out)


def segment_moments(rows: torch.Tensor, nf: int, offsets: torch.Tensor,
                    sel: torch.Tensor, tabs: Sequence[Sequence[int]],
                    centre: torch.Tensor, uvel: torch.Tensor,
                    axis: torch.Tensor) -> torch.Tensor:
    """(S, ng1, ``columns(nf)``) float64 sums of each selection's rows
    group by group (the module's docstring): the kernel's for a CUDA
    tensor, the plain version's in the rows' float32 for a CPU one."""
    if rows.dim() != 2 or rows.shape[1] < 7 + nf or not \
            0 <= nf <= MAX_FIELDS:
        raise ValueError(f"rows: expected (n, >= {7 + nf}) with at most "
                         f"{MAX_FIELDS} fields, got {tuple(rows.shape)}, "
                         f"nf={nf}")
    n, F = int(rows.shape[0]), int(rows.shape[1])
    dev = rows.device
    require(rows, "rows", torch.float32, (n, F), dev)
    if offsets.dim() != 1 or offsets.shape[0] < 2:
        raise ValueError(f"offsets: expected (ng1 + 1,), got "
                         f"{tuple(offsets.shape)}")
    ng1 = int(offsets.shape[0]) - 1
    require(offsets, "offsets", torch.int64, (ng1 + 1,), dev)
    S = len(tabs)
    require(sel, "sel", torch.bool, (n, S), dev)
    for name, t in (("centre", centre), ("uvel", uvel), ("axis", axis)):
        if t.dim() != 3:
            raise ValueError(f"{name}: expected (T, {ng1}, 3), got "
                             f"{tuple(t.shape)}")
        require(t, name, torch.float64, (t.shape[0], ng1, 3), dev)
    limits = (centre.shape[0], uvel.shape[0], axis.shape[0])
    for s, idx in enumerate(tabs):
        if len(idx) != 3 or any(not 0 <= int(i) < lim
                                for i, lim in zip(idx, limits)):
            raise ValueError(f"tabs[{s}] = {tuple(idx)}: outside the "
                             f"tables' {limits} entries")
    if not kernel_device(rows):
        return segment_moments_ref(rows, nf, offsets, sel, tabs, centre,
                                   uvel, axis, acc=rows.dtype)
    out = torch.empty(S, ng1, columns(nf), dtype=torch.float64, device=dev)
    lib = load_library()
    sel8 = sel.view(torch.uint8)
    with on_device(rows):
        for s0 in range(0, S, MAX_SEL):
            chunk = [int(i) for idx in tabs[s0:s0 + MAX_SEL] for i in idx]
            host = (ctypes.c_int * len(chunk))(*chunk)
            check(lib.vr_segment_moments(
                rows.data_ptr(), F, nf, n, offsets.data_ptr(), ng1,
                sel8.data_ptr(), S, s0, len(chunk) // 3,
                ctypes.addressof(host), centre.data_ptr(), uvel.data_ptr(),
                axis.data_ptr(), out.data_ptr(), stream(rows)),
                "vr_segment_moments")
            LAUNCHES["segment_moments"] += 1
    return out
