"""Substructure search: phase-space outliers, stream FOF, merger cores and
the recursion over levels (port of velociraptor_stf_tpu/models/
substructure.py: the pair criteria, ``subset_predicate``,
``significance_filter``, the batched subset search (``_subset_preds``,
``_search_subset_batch``), the three host merges, the padded structure
context, ``structure_outliers``, ``search_sub_sub``, ``Pred6DCore``,
and the merger-core search, which the reference runs per structure).

A level's structures take one route, whatever the options: the subset
search and the merger-core search each run over all of them at once, a
single structure being a batch of one.

* ``search_subset_batch`` (reference SearchSubset, search.cxx:910-1816):
  a pair links when both particles are outliers (ell >= threshold), lie
  within the substructure linking length and move alike (speed ratio
  within Vratio, velocity angle below thetaopen); with
  ``Iterative_searchflag`` a tightened first pass, two attach expansions
  and the fmerge link merge (MergeGroups); ``significance_filter``
  (CheckSignificance, :2947) sheds low-ell members until a group is
  significant.  One cell sort keyed by (structure, cell) at the widest
  reach serves every pass (FOFSTPROBNNNODIST's first pass, which has no
  linking length, takes every candidate of a second sort at the linking
  length), then batches of whole structures under an exact pair budget;
  in each, every graph pass on ids offset by structure, with at most two
  host fetches a batch.  The reference's pow2 lane classes, pair cap and
  fallbacks served XLA's static shapes and are not carried over.
* ``search_cores_batch`` (search.cxx:1530-1816, HaloCoreGrowth:1817):
  one cell sort keyed by (structure, cell) at the longest length of the
  loops, each structure's lengths, sizes and cores on the device, one
  label fixed point a loop over the union of the live structures' links,
  then the phase-tensor growth with cores keyed (structure, core).  A
  structure's ids do not depend on the others in its batch: the velocity
  scale's segment sums, the link's tensor divisions and the growth's
  elementwise Cholesky factor and distance round the same in any batch.
* ``search_sub_sub`` (SearchSubSub, :2480-2946): the velocity density once
  over the particles of structures of at least MINSUBSIZE members, then per
  level: each structure's padded context (``_prep_class``), its background
  grid and outlier values, the subset search, the merger-core search, one
  unbind over every candidate of the level, and the splice of the new ids
  with their parents.

The padding is part of the result.  A structure of nsub members is padded
to npad = next_pow2(nsub) >= 1024 rows, the extra rows zero-mass points on
a lattice outside the structure, exactly as the reference pads it: the
background grid's median splits and the outlier histograms' bin counts
see those rows.  The edge searches do not (padded rows are never
outliers, never eligible, never tagged), so they, the core search and the
unbind run on the structure's own rows; the padded bounds still set the
cell grid, as they do in the reference.  Structures of one pad size share
one batched context build and one outlier pass.  A pair's orientation
(which end is the criterion's own side, where the speed-ratio test can
differ in the last bit) is that of the structure's own cell order on its
own padded bounds, as in the reference's per-structure search; the
reference's batch orients pairs on a grid over its lane class's joint
bounds.  The reference's environment switches are not ported.

With a mesh (``parallel/``), the density is sharded as x-slabs once the
active set reaches ``distributed_localfield.DIST_DENSITY_MIN`` particles
(approximative mode only), and each level's structures are dealt whole to
the shards, each running one subset search and one core search over its
structures (``parallel/distributed_substructure.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..io import cache as cache_io
from ..kernels._common import BIG_I32
from ..ops import fof, segments as seg
from ..utils import config as C
from ..utils import telemetry
from ..utils.timing import span
from ..utils.transfer import fetch_small
from ..parallel import distributed_localfield
from . import bgfield, localfield, unbind as unbind_mod


# ---------------------------------------------------------------------------
# Pair criteria (reference fofalgo.cxx)
# ---------------------------------------------------------------------------

def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + \
        a[..., 2] * b[..., 2]


def _stream_terms(own, nbr):
    """(cos of the velocity angle, speed ratio) of each pair."""
    v_own, v_nbr = own["vel"], nbr["vel"]
    v1 = torch.sqrt(seg.sq3(v_own))
    v2 = torch.sqrt(seg.sq3(v_nbr))
    vdot = _dot3(v_own, v_nbr) / torch.clamp_min(v1 * v2, 1e-30)
    return vdot, v1 / torch.clamp_min(v2, 1e-30)


def _ratio_ok(ratio, vratio: float):
    return (ratio < vratio) & (ratio > 1.0 / vratio)


@dataclasses.dataclass(frozen=True)
class StreamPred:
    """FOFStreamwithprob (fofalgo.cxx:21-34): both outliers, within the
    linking length, aligned and of similar speed."""

    symmetric = True

    b2: float
    vratio: float
    costheta: float
    ellthr: float

    def __call__(self, d2, own, nbr):
        vdot, ratio = _stream_terms(own, nbr)
        ok = (d2 < self.b2) & (vdot > self.costheta) & \
            _ratio_ok(ratio, self.vratio)
        return ok & (own["ell"] >= self.ellthr) & (nbr["ell"] >= self.ellthr)


@dataclasses.dataclass(frozen=True)
class StreamPredAttach:
    """FOFStreamwithprobIterative (fofalgo.cxx:36-50): one of the pair
    (the tagged side) needs to be an outlier; used to attach."""

    b2: float
    vratio: float
    costheta: float
    ellthr: float

    def __call__(self, d2, own, nbr):
        vdot, ratio = _stream_terms(own, nbr)
        ok = (d2 < self.b2) & (vdot > self.costheta) & \
            _ratio_ok(ratio, self.vratio)
        return ok & ((own["ell"] >= self.ellthr) |
                     (nbr["ell"] >= self.ellthr))


@dataclasses.dataclass(frozen=True)
class StreamPredNoProb:
    """FOFStream (fofalgo.cxx:7-19): the stream criterion without the
    outlier gate."""

    symmetric = True

    b2: float
    vratio: float
    costheta: float

    def __call__(self, d2, own, nbr):
        vdot, ratio = _stream_terms(own, nbr)
        return (d2 < self.b2) & (vdot > self.costheta) & \
            _ratio_ok(ratio, self.vratio)


@dataclasses.dataclass(frozen=True)
class StreamPredNoDist:
    """FOFStreamwithprobNNNODIST (fofalgo.cxx:68-81): no linking length;
    any pair of the candidate stencil links on the velocity and outlier
    gates."""

    symmetric = True

    vratio: float
    costheta: float
    ellthr: float

    def __call__(self, d2, own, nbr):
        vdot, ratio = _stream_terms(own, nbr)
        ok = (vdot > self.costheta) & _ratio_ok(ratio, self.vratio)
        return ok & (own["ell"] >= self.ellthr) & (nbr["ell"] >= self.ellthr)


@dataclasses.dataclass(frozen=True)
class StreamPredLX:
    """FOFStreamwithprobLX (fofalgo.cxx:83-101): per-axis linking lengths
    shrunk along each particle's velocity; the pair links if either
    particle's scaled distance is within 1."""

    symmetric = True

    b2: float
    vratio: float
    costheta: float
    ellthr: float

    def __call__(self, d2, own, nbr):
        v_own, v_nbr = own["vel"], nbr["vel"]
        dx = own["pos"] - nbr["pos"]
        v1sq = torch.clamp_min(seg.sq3(v_own), 1e-30)
        v2sq = torch.clamp_min(seg.sq3(v_nbr), 1e-30)

        def scaled(v, vsq):
            f = 0.25 * (1.0 + v * v / vsq[..., None]) ** 2
            t = dx * dx / (self.b2 * f)
            return t[..., 0] + t[..., 1] + t[..., 2]

        total = torch.minimum(scaled(v_own, v1sq), scaled(v_nbr, v2sq))
        v1, v2 = torch.sqrt(v1sq), torch.sqrt(v2sq)
        vdot = _dot3(v_own, v_nbr) / torch.clamp_min(v1 * v2, 1e-30)
        ok = (total <= 1.0) & (vdot > self.costheta) & \
            _ratio_ok(v1 / v2, self.vratio)
        return ok & (own["ell"] >= self.ellthr) & (nbr["ell"] >= self.ellthr)


@dataclasses.dataclass(frozen=True)
class StreamPredScaleEllB:
    """FOFStreamwithprobscaleell (fofalgo.cxx:120-137): the linking
    length scaled by (lighter mass / reference mass)^(2/3), the reference
    mass the per-particle field ``scal`` (the reference's batched
    form)."""

    symmetric = True

    b2: float
    vratio: float
    costheta: float
    ellthr: float

    def __call__(self, d2, own, nbr):
        mmin = torch.minimum(own["mass"], nbr["mass"])
        mref = torch.clamp_min(own["scal"], 1e-30)
        ellscale = self.b2 * torch.pow(
            torch.clamp_min(mmin / mref, 1e-30), 2.0 / 3.0)
        vdot, ratio = _stream_terms(own, nbr)
        ok = (d2 < ellscale) & (vdot > self.costheta) & \
            _ratio_ok(ratio, self.vratio)
        return ok & (own["ell"] >= self.ellthr) & (nbr["ell"] >= self.ellthr)


@dataclasses.dataclass(frozen=True)
class Pred6DOutlierB:
    """FOF6dbgup (fofalgo.cxx:166-174): the 6D metric, both outliers
    (FOF6DSUBSET), the velocity scale the per-particle field ``scal``
    (the reference's batched form)."""

    symmetric = True

    b2: float
    ellthr: float

    def __call__(self, d2, own, nbr):
        dv2 = seg.sq3(own["vel"] - nbr["vel"])
        ok = d2 / self.b2 + dv2 / torch.clamp_min(own["scal"], 1e-30) < 1.0
        return ok & (own["ell"] >= self.ellthr) & (nbr["ell"] >= self.ellthr)


@dataclasses.dataclass(frozen=True)
class Pred6DBackground:
    """FOF6dbg (fofalgo.cxx:156-164): the 6D metric between particles
    below the outlier threshold."""

    symmetric = True

    b2: float
    v2: float
    ellthr: float

    def __call__(self, d2, own, nbr):
        dv2 = seg.sq3(own["vel"] - nbr["vel"])
        ok = d2 / self.b2 + dv2 / self.v2 < 1.0
        return ok & (own["ell"] < self.ellthr) & (nbr["ell"] < self.ellthr)


@dataclasses.dataclass(frozen=True)
class Pred6DCore:
    """FOF6d between eligible (untagged) particles (reference FOF6d with
    the FOFcheckbg gate, search.cxx:1596-1600).  ``b2`` and ``v2``: floats,
    or float32 tensors, 0-d or one per pair (``_core_link``)."""

    b2: float
    v2: float

    def __call__(self, d2, own, nbr):
        ok = _core_link(d2, seg.sq3(own["vel"] - nbr["vel"]), self.b2,
                        self.v2)
        return ok & (own["elig"] > 0) & (nbr["elig"] > 0)


def _core_link(d2, dv2, b2, v2):
    """The core search's 6D link, dx^2/b2 + dv^2/v2 <= 1.  Both searches
    give ``b2`` and ``v2`` as device tensors: a CUDA division by a host
    scalar multiplies by its reciprocal, a division by a tensor divides,
    so the two would round apart."""
    return d2 / b2 + dv2 / v2 <= 1.0


def subset_predicate(opt: C.Options, ellx2: float, vratio: float,
                     costheta: float, ellthr: float):
    """FoF_search_type -> pair criterion (reference search.cxx:910-1010);
    the NN variants map to the same criteria.  ScaleEll and FOF6DSUBSET
    read their structure's mean mass or velocity scale from the per-row
    field ``scal`` (``_structure_scal``)."""
    ft = opt.foftype
    if ft in (C.FOFSTPROB, C.FOFSTPROBNN, C.FOFSTNOSUBSET):
        return StreamPred(ellx2, vratio, costheta, ellthr)
    if ft in (C.FOFSTPROBLX, C.FOFSTPROBNNLX):
        return StreamPredLX(ellx2, vratio, costheta, ellthr)
    if ft == C.FOFSTPROBNNNODIST:
        return StreamPredNoDist(vratio, costheta, ellthr)
    if ft in (C.FOFSTPROBSCALEELL, C.FOFSTPROBSCALEELLNN):
        return StreamPredScaleEllB(ellx2, vratio, costheta, ellthr)
    if ft == C.FOF6DSUBSET:
        return Pred6DOutlierB(ellx2, ellthr)
    return StreamPred(ellx2, vratio, costheta, ellthr)


# ---------------------------------------------------------------------------
# Significance and the subset search over many structures at once
# (reference SearchSubset, search.cxx:910-1816, and _search_subset_batch,
# substructure.py:844-1180)
# ---------------------------------------------------------------------------

def significance_filter(ell: torch.Tensor, pfof: torch.Tensor,
                        num_groups: int, ellthreshold: float,
                        siglevel: float, min_size: int) -> torch.Tensor:
    """Reference CheckSignificance (search.cxx:2947): each group keeps its
    largest top-ell prefix of k members whose beta = (mean ell /
    E[ell | ell > thr] - 1) sqrt(k) >= siglevel; below ``min_size`` it
    dissolves.  The per-group running sums are float64 (the reference
    takes one float32 prefix sum over all rows)."""
    thr = ellthreshold
    ellaveexp = math.sqrt(2.0 / math.pi) * math.exp(-0.5 * thr * thr) / \
        max(1.0 - math.erf(thr / math.sqrt(2.0)), 1e-300)
    order = seg.lexsort2(-ell, pfof)
    g_s = pfof[order]
    e_o = ell[order]
    e_s = torch.where((g_s > 0) & torch.isfinite(e_o), e_o, 0.0)
    offsets = seg.group_offsets(g_s, num_groups)
    rank = seg.segment_rank(g_s, offsets)
    cume = seg.segment_cumsum(e_s, g_s, offsets)
    k = (rank + 1).to(ell.dtype)
    beta = (cume / k / ellaveexp - 1.0) * torch.sqrt(k)
    okk = (beta >= siglevel) & (g_s > 0)
    kstar = seg.segment_max(torch.where(okk, rank + 1, 0), g_s,
                            num_groups + 1)
    kstar = torch.where(kstar >= min_size, kstar, 0)
    keep = torch.zeros_like(pfof, dtype=torch.bool)
    keep[order] = (rank < kstar[g_s]) & (g_s > 0)
    return torch.where(keep, pfof, 0)


def _scatter_back(values_s: torch.Tensor, order: torch.Tensor
                  ) -> torch.Tensor:
    out = torch.empty_like(values_s)
    out[order] = values_s
    return out


def _subset_preds(opt: C.Options):
    """(pred0, minsize0, iterative) of the subset search: with
    ``iiterflag`` the tightened first pass and its minimum size, and
    ``iterative`` = (pred_att, pred_att2, pred_merge), the two attach
    criteria and the link merge's; without it the base thresholds,
    ``MinSize`` and None."""
    ellx2 = (opt.ellxscale * opt.ellphys) ** 2
    if not opt.iiterflag:
        return (subset_predicate(opt, ellx2, opt.Vratio,
                                 math.cos(opt.thetaopen * math.pi),
                                 opt.ellthreshold), opt.MinSize, None)
    vratio = opt.Vratio * opt.vfac
    costh_it = math.cos(opt.thetaopen * math.pi * opt.thetafac)
    thr0 = opt.ellthreshold * opt.ellfac
    return (subset_predicate(opt, ellx2, vratio, costh_it, thr0),
            max(2, int(opt.MinSize * opt.nminfac)),
            (StreamPredAttach(ellx2, vratio, costh_it, opt.ellthreshold),
             StreamPredAttach(ellx2 * opt.ellxfac ** 2, vratio, costh_it,
                              thr0),
             StreamPred(ellx2, vratio, costh_it, thr0)))


def _structure_scal(opt: C.Options, vel, mass, sid, nsub, npad
                    ) -> Optional[torch.Tensor]:
    """(nseg,) float32 per-structure ``scal`` of the ScaleEll and
    FOF6DSUBSET criteria, over the reference's padded rows (zero mass and
    velocity): the mean mass (ScaleEll) or the mean per-axis velocity
    variance times ellvel^2 (FOF6DSUBSET); None for the other foftypes.
    Sums are float64 sorted segment sums over the valid rows (``sid``:
    each row's structure, non-decreasing), rounded to float32 once, where
    numpy's float32 mean can differ in the last bit."""
    nseg = npad.shape[0]
    npad = npad.double()
    if opt.foftype in (C.FOFSTPROBSCALEELL, C.FOFSTPROBSCALEELLNN):
        m = (seg.segment_sum(mass.double(), sid, nseg, presorted=True) /
             npad).float()
        return torch.where(torch.isfinite(m) & (m > 0), m, 1.0)
    if opt.foftype != C.FOF6DSUBSET:
        return None
    v = vel.double()
    mu = seg.segment_sum(v, sid, nseg, presorted=True) / npad[:, None]
    dev2 = seg.segment_sum((v - mu[sid]) ** 2, sid, nseg, presorted=True) + \
        (npad - nsub.double())[:, None] * mu * mu
    var = (dev2 / npad[:, None]).float()
    # numpy's mean of three float32 values: two sums, a true division
    sv = (var[:, 0] + var[:, 1] + var[:, 2]) / torch.full_like(var[:, 0], 3.0)
    sv = torch.where(torch.isfinite(sv) & (sv > 0), sv, 1.0)
    return (sv.double() * opt.ellvel ** 2).float()


def search_subset_batch(opt: C.Options, entries: List[dict],
                        pair_budget: Optional[int] = None) -> None:
    """The subset search of many structures at once (one structure is a
    batch of one): fills ``e["sub"]`` (int64 ids in the structure's row
    order, 1..ng by size) and ``e["ng_sub"]`` of every entry
    (``search_sub_sub``'s, with its valid rows ``ppos``/``pvel``/
    ``pmass``/``ell`` ``[:nsub]``, ``npad`` and host ``bounds``), and
    counts the padded rows searched (``subset_batched_particles``).

    A pair links when both particles are outliers (ell >= threshold), lie
    within the substructure linking length and move alike (the foftype's
    criterion, ``subset_predicate``); with ``iiterflag`` a tightened
    first pass, two attach expansions and the fmerge link merge
    (MergeGroups); then ``significance_filter`` (CheckSignificance,
    :2947) and the renumbering by size.  One cell sort of every
    structure's rows, keyed by (structure, cell) on each structure's own
    grid over its padded bounds (``fof.segmented_cells``) at the widest
    reach of the passes, serves them all, so a pair is oriented, and its
    links evaluated, as the reference's per-structure search orients it.
    Where the first pass is a plain FOF under its criterion (no
    ``iiterflag``, or FOFSTPROBNNNODIST, which has no linking length and
    links any candidate of the stencil) it takes every candidate of a
    sort at the linking length, as the reference's ``fof3d`` does.  The
    structures go in batches of whole structures whose candidate slots
    fit ``pair_budget`` (default: ``cell_pairs``' budget, 2^24 on a card,
    2^22 on the host); one fetch of the per-structure candidate totals
    sets them.  Each batch runs ``_subset_batch``: every pass on ids
    offset by structure, at most two host fetches."""
    if not entries:
        return
    dev = entries[0]["ppos"].device
    nsub = [int(e["nsub"]) for e in entries]

    def rows(key):
        return torch.cat([e[key][:e["nsub"]] for e in entries])

    pos, vel, mass, ell = (rows(k) for k in ("ppos", "pvel", "pmass", "ell"))
    bounds = [e["bounds"] for e in entries]
    b = math.sqrt((opt.ellxscale * opt.ellphys) ** 2)
    reach = b * max(1.0, opt.ellxfac) if opt.iiterflag else b
    cells = fof.segmented_cells(pos, nsub, bounds, reach)
    first = None                   # the first pass cuts the shared table
    if not opt.iiterflag:
        first = cells
    elif opt.foftype == C.FOFSTPROBNNNODIST:
        first = fof.segmented_cells(pos, nsub, bounds, b)
    fields = {"ell": ell, "vel": vel}
    if opt.foftype in (C.FOFSTPROBSCALEELL, C.FOFSTPROBSCALEELLNN):
        fields["mass"] = mass
    if opt.foftype in (C.FOFSTPROBLX, C.FOFSTPROBNNLX):
        fields["pos"] = pos
    scal = _structure_scal(opt, vel, mass, cells.seg,
                           torch.tensor(nsub, device=dev),
                           torch.tensor([e["npad"] for e in entries],
                                        device=dev))
    if scal is not None:
        fields["scal"] = scal[cells.seg]
    candidates = cells.candidates()
    if first is not None and first is not cells:
        candidates = torch.maximum(candidates, first.candidates())
    totals = fetch_small(candidates)
    telemetry.count("subset_batch_candidates", int(totals.sum()))
    preds = _subset_preds(opt)
    runs = _budget_runs(totals, pair_budget or _pair_budget(dev))
    for k0, k1 in runs:
        _subset_batch(opt, entries, cells, first, fields, ell, k0, k1, preds,
                      reach)
    telemetry.count("subset_batches", len(runs))
    telemetry.count("subset_batched_particles",
                    sum(e["npad"] for e in entries))


def _pair_budget(dev: torch.device) -> int:
    """Candidate slots a batch of whole structures may hold:
    ``cell_pairs``' budget, 2^24 on a card, 2^22 on the host."""
    return (1 << 24) if dev.type == "cuda" else (1 << 22)


def _budget_runs(totals: np.ndarray, budget: int) -> List[Tuple[int, int]]:
    """Consecutive structures [k0, k1) whose candidate slots (``totals``)
    fit ``budget`` together; a structure over it alone."""
    runs, k0 = [], 0
    while k0 < len(totals):
        k1, tot = k0 + 1, int(totals[k0])
        while k1 < len(totals) and tot + int(totals[k1]) <= budget:
            tot += int(totals[k1])
            k1 += 1
        runs.append((k0, k1))
        k0 = k1
    return runs


def _batch_pairs(tab: fof.SegmentedCells, fields, r0: int, r1: int,
                 reach: Optional[float]):
    """(erow, ecol, d2, own, nbr) of the sorted rows [r0, r1) of ``tab``
    (``SegmentedCells.pairs``; ``reach`` None: every candidate) with the
    ``fields`` (original row order) of each pair's two ends."""
    erow, ecol, d2 = tab.pairs(r0, r1, reach)
    telemetry.count("subset_batch_pairs", int(erow.shape[0]))
    fs = {k: v[tab.order[r0:r1]] for k, v in fields.items()}
    return erow, ecol, d2, fof._gather(fs, erow), fof._gather(fs, ecol)


def _links(pred, erow, ecol, d2, own, nbr):
    """The (row, column) pairs of ``_batch_pairs`` that ``pred`` links."""
    m = pred(d2, own, nbr)
    return erow[m], ecol[m]


def _subset_batch(opt: C.Options, entries: List[dict],
                  cells: fof.SegmentedCells,
                  first: Optional[fof.SegmentedCells], fields, ell, k0: int,
                  k1: int, preds, reach: float) -> None:
    """The subset search of structures k0..k1-1 (sorted rows r0..r1-1 of
    ``cells``): the first pass's links (over ``cells``' pairs within
    ``reach``, or over every candidate of ``first``, mapped to ``cells``'
    rows), its label fixed point and the by-size renumbering per
    structure (a batch without a group ends there); with ``iiterflag``
    the expansions and the link merge over ``cells``' pairs
    (``_expand_and_merge``); the significance filter, the final
    renumbering per structure and one fetch of the group counts.  Group
    ids run over the whole batch, structure after structure, so no pass
    mixes two."""
    dev = ell.device
    nseg = k1 - k0
    r0, r1 = int(cells.starts[k0]), int(cells.starts[k1])
    n = r1 - r0
    pred0, minsize0, iterative = preds
    order = cells.order[r0:r1] - r0            # sorted -> original row
    shared = None
    if first is None:
        shared = _batch_pairs(cells, fields, r0, r1, reach)
        e0 = _links(pred0, *shared)
    else:
        e0 = _links(pred0, *_batch_pairs(first, fields, r0, r1, None))
        if first is not cells:
            # ``first``'s sorted rows -> ``cells``' sorted rows
            to_cells = _scatter_back(torch.arange(n, device=dev), order)[
                first.order[r0:r1] - r0]
            e0 = (to_cells[e0[0]], to_cells[e0[1]])
    sid = cells.seg[r0:r1] - k0                # structure of each row
    first_row = torch.from_numpy(cells.starts[k0:k1] - r0).to(dev)
    src = order - first_row[sid]               # row within its structure
    labels = fof.fof_labels_from_edges(*e0, n, undirected=True)
    del e0
    sizes = torch.bincount(labels, minlength=n)
    min_src = torch.full((n,), BIG_I32, dtype=torch.int64,
                         device=dev).scatter_reduce_(0, labels, src, "amin")
    gid, _, ng0 = seg.renumber_segments(sid, sizes, min_src,
                                        sizes >= minsize0, nseg)
    ngrp = int(ng0.sum())
    if ngrp == 0:
        _fill_batch(entries, cells, k0, k1,
                    torch.zeros(n, dtype=torch.int64, device=dev),
                    np.zeros(nseg, np.int64))
        return
    # the structure of each group id
    gkey = torch.cat([ng0.new_zeros(1), torch.repeat_interleave(
        torch.arange(nseg, device=dev), ng0, output_size=ngrp)])
    lab = gid[labels]
    if iterative is not None:
        if shared is None:
            shared = _batch_pairs(cells, fields, r0, r1, reach)
        links = _iterative_links(iterative, *shared)
        del shared
        lab = _expand_and_merge(opt, links, lab, ng0, ngrp, gkey)
    pfof = significance_filter(ell[r0:r1], _scatter_back(lab, order), ngrp,
                               opt.ellthreshold, opt.siglevel, opt.MinSize)
    sizes = torch.bincount(pfof, minlength=ngrp + 1)
    ids = torch.arange(ngrp + 1, device=dev)
    _, local, ngf = seg.renumber_segments(
        gkey, sizes, ids, (sizes >= opt.MinSize) & (ids > 0), nseg)
    _fill_batch(entries, cells, k0, k1, local[pfof], fetch_small(ngf))


def _iterative_links(iterative, erow, ecol, d2, own, nbr):
    """(merge, first attach, second attach) links of ``_batch_pairs``'
    pairs: the merge criterion once a pair, the attach criteria both
    ways."""
    pred_att, pred_att2, pred_merge = iterative

    def both_ways(pred):
        mf, mb = pred(d2, own, nbr), pred(d2, nbr, own)
        return (torch.cat([erow[mf], ecol[mb]]),
                torch.cat([ecol[mf], erow[mb]]))

    return (_links(pred_merge, erow, ecol, d2, own, nbr),
            both_ways(pred_att), both_ways(pred_att2))


def _expand_and_merge(opt: C.Options, links, lab, ng0, ngrp: int,
                      gkey) -> torch.Tensor:
    """The iterative passes from the first pass's group ids ``lab``
    (sorted rows) along ``_iterative_links``: the first attach, the
    cross-group link counts keyed by (structure, i, j), one fetch of them
    and the host MergeGroups loop per structure (``_merge_targets``), the
    merge targets and the relaxed second attach.  Returns the group ids
    of the sorted rows."""
    em, att1, att2 = links
    gbase = torch.cumsum(ng0, 0) - ng0         # each structure's first id - 1
    lab1 = fof.attach_rounds(lab, *att1, 16)
    sizes1 = torch.bincount(lab1, minlength=ngrp + 1)
    gi, gj = lab1[em[0]], lab1[em[1]]
    gi, gj = torch.cat([gi, gj]), torch.cat([gj, gi])
    key = gkey[gi]
    pk, pi, pj, pc = seg.pair_counts(gi - gbase[key], gj - gbase[key],
                                     (gi > 0) & (gj > 0) & (gi != gj), key)
    ng0_h, pk, pi, pj, pc, szj = fetch_small(
        (ng0, pk, pi, pj, pc, sizes1[gbase[pk] + pj]))
    target = torch.from_numpy(_merge_targets(opt, ng0_h, pk, pi, pj, pc,
                                             szj)).to(lab.device)
    return fof.attach_rounds(target[lab1], *att2, 16)


def _merge_targets(opt: C.Options, ng0, pk, pi, pj, pc, szj) -> np.ndarray:
    """The batch's merge map over its group ids: per structure the
    reference's MergeGroups loop (search.cxx:1200-1224, 3894) over its
    lexicographic (i, j) link pairs in local ids: j joins i when their
    links outnumber fmerge x (j's size after the first attach), unless
    either was absorbed.  A pair under the float64 threshold never merges
    whatever came before, so only the others are walked."""
    base = np.cumsum(ng0) - ng0
    target = np.arange(int(ng0.sum()) + 1)
    strong = pc > opt.fmerge * szj.astype(np.float64)
    for s in np.unique(pk[strong]):
        sel = strong & (pk == s)
        absorbed = np.zeros(ng0[s] + 1, bool)
        tgt = np.arange(ng0[s] + 1)
        for i, j in zip(pi[sel], pj[sel]):
            if absorbed[i] or absorbed[j]:
                continue
            absorbed[j] = True
            tgt[tgt == j] = i
        target[base[s] + 1:base[s] + ng0[s] + 1] = base[s] + tgt[1:]
    return target


def _fill_batch(entries: List[dict], cells: fof.SegmentedCells, k0: int,
                k1: int, sub: torch.Tensor, ng: np.ndarray) -> None:
    """Each structure's ids (a view of the batch's, rows in their order)
    and group count."""
    r0 = int(cells.starts[k0])
    for k in range(k0, k1):
        a = int(cells.starts[k]) - r0
        entries[k]["sub"] = sub[a:a + entries[k]["nsub"]]
        entries[k]["ng_sub"] = int(ng[k - k0])


# ---------------------------------------------------------------------------
# Host phase merges (reference MergeSubstructures*, search.cxx:2146-2480)
# ---------------------------------------------------------------------------

def _group_phase_stats(pos, vel, mass, pfof_np, ng: int):
    """Per-group mass-weighted phase centres and scalar dispersions
    (reference MergeSubstructures* preamble, search.cxx:2171-2235)."""
    m = np.asarray(mass, np.float64)
    w = np.where(pfof_np > 0, m, 0.0)
    msum = np.zeros(ng + 1)
    np.add.at(msum, pfof_np, w)
    msum = np.maximum(msum, 1e-30)
    mu_x = np.zeros((ng + 1, 3))
    mu_v = np.zeros((ng + 1, 3))
    np.add.at(mu_x, pfof_np, np.asarray(pos, np.float64) * w[:, None])
    np.add.at(mu_v, pfof_np, np.asarray(vel, np.float64) * w[:, None])
    mu_x /= msum[:, None]
    mu_v /= msum[:, None]
    sigX = np.zeros(ng + 1)
    sigV = np.zeros(ng + 1)
    np.add.at(sigX, pfof_np,
              np.sum((pos - mu_x[pfof_np]) ** 2, axis=1) * w)
    np.add.at(sigV, pfof_np,
              np.sum((vel - mu_v[pfof_np]) ** 2, axis=1) * w)
    sigX = np.maximum(sigX / msum, 1e-30)
    sigV = np.maximum(sigV / msum, 1e-30)
    return mu_x, mu_v, sigX, sigV


def merge_substructures_cores_phase(pos, vel, mass, pfof, numsubs: int,
                                    numcores: int, fdist: float
                                    ) -> Tuple[np.ndarray, int]:
    """Merge 6DFOF cores into phase-overlapping substructures.

    Reference MergeSubstructuresCoresPhase (search.cxx:2146-2289): group ids
    1..numsubs are substructures, numsubs+1..numsubs+numcores are cores; a
    core merges into the phase-nearest substructure when the normalized
    phase distance (dx^2/sigX_core + dv^2/sigV_core) < fdist^2.  Returns
    (pfof, new_numcores) with surviving cores renumbered to stay contiguous
    after the substructures.
    """
    pfof_np = np.asarray(pfof).copy()
    ng = numsubs + numcores
    if numsubs == 0 or numcores == 0 or fdist <= 0:
        return pfof_np, numcores
    mu_x, mu_v, sigX, sigV = _group_phase_stats(pos, vel, mass, pfof_np, ng)
    f2 = fdist * fdist
    newid = np.arange(ng + 1)
    kept = []
    for c in range(numsubs + 1, ng + 1):
        dx2 = np.sum((mu_x[1:numsubs + 1] - mu_x[c]) ** 2, axis=1)
        dv2 = np.sum((mu_v[1:numsubs + 1] - mu_v[c]) ** 2, axis=1)
        d2 = dx2 / sigX[c] + dv2 / sigV[c]
        j = int(np.argmin(d2))
        if d2[j] < f2 and dx2[j] < sigX[c] * f2:
            newid[c] = j + 1
        else:
            kept.append(c)
    for rank, c in enumerate(kept):
        newid[c] = numsubs + 1 + rank
    return newid[pfof_np].astype(np.int32), len(kept)


def merge_substructures_phase(pos, vel, mass, pfof, numsubs: int,
                              numcores: int, fdist: float
                              ) -> Tuple[np.ndarray, int, int]:
    """Merge phase-overlapping substructures with each other.

    Reference MergeSubstructuresPhase (search.cxx:2289-2480): substructure j
    merges into i when their mutual normalized phase distances (each
    normalized by its own dispersions) are both < fdist^2.  Cores (ids >
    numsubs) are never absorbed into by substructures but may absorb.
    Returns (pfof, numsubs, numcores) with ids compacted.
    """
    pfof_np = np.asarray(pfof).copy()
    ng = numsubs + numcores
    if ng <= 1 or fdist <= 0:
        return pfof_np, numsubs, numcores
    mu_x, mu_v, sigX, sigV = _group_phase_stats(pos, vel, mass, pfof_np, ng)
    f2 = fdist * fdist
    absorbed = np.zeros(ng + 1, bool)
    target = np.arange(ng + 1)
    isig_x, isig_v = 1.0 / sigX, 1.0 / sigV
    for i in range(1, numsubs + 1):      # subs iterate; cores don't absorb
        if absorbed[i]:
            continue
        dx2 = np.einsum("jd,jd->j", mu_x - mu_x[i], mu_x - mu_x[i])
        dv2 = np.einsum("jd,jd->j", mu_v - mu_v[i], mu_v - mu_v[i])
        d1 = dx2 * isig_x[i] + dv2 * isig_v[i]
        d2 = dx2 * isig_x + dv2 * isig_v
        ok = (d1 < f2) & (d2 < f2) & ~absorbed
        ok[0] = ok[i] = False
        if not ok.any():
            continue
        d = np.where(ok, 0.5 * (d1 + d2), np.inf)
        best = int(np.argmin(d))
        absorbed[best] = True
        target[target == best] = i
    if not absorbed.any():
        return pfof_np, numsubs, numcores
    # compact ids: surviving subs first, then surviving cores
    surv = [g for g in range(1, ng + 1) if not absorbed[g]]
    remap = np.zeros(ng + 1, np.int64)
    nsub_new = 0
    for rank, g in enumerate(surv):
        remap[g] = rank + 1
        if g <= numsubs:
            nsub_new += 1
    pfof_np = remap[target[pfof_np]].astype(np.int32)
    return pfof_np, nsub_new, len(surv) - nsub_new


# ---------------------------------------------------------------------------
# Padded structure context and outlier values
# ---------------------------------------------------------------------------

def _next_pow2(x: int, lo: int = 1024) -> int:
    k = lo
    while k < x:
        k *= 2
    return k


def _lattice(ii: torch.Tensor, side: torch.Tensor, dtype) -> torch.Tensor:
    """(..., 3) cubic lattice coordinates of the slot numbers ``ii``."""
    sd = torch.clamp_min(side, 1)
    return torch.stack([ii % sd, (ii // sd) % sd, ii // (sd * sd)],
                       -1).to(dtype)


def _prep_class(pos, vel, mass, dens, order, starts, nsubs, sides,
                npad: int, boxsize: float, spacing: float, cmadjust: bool):
    """Padded contexts of B structures of one pad size, gathered from the
    group-sorted ``order`` (reference ``_prep_class_device``): members
    unwrapped about the first one, shifted to their centre of mass
    (``icmrefadjust``), then the pad lattice.  Returns (idx (B, npad),
    pos, vel, mass, valid, dens or None)."""
    n = pos.shape[0]
    dev = pos.device
    ar = torch.arange(npad, device=dev)
    valid = ar[None, :] < nsubs[:, None]
    slot = torch.minimum(starts[:, None] + ar[None, :],
                         (starts + nsubs - 1)[:, None])
    idx = order[torch.clamp(slot, 0, n - 1)]
    gpos, gvel = pos[idx], vel[idx]
    gmass = torch.where(valid, mass[idx], 0.0)
    if boxsize:
        ref = gpos[:, 0:1]
        d = gpos - ref
        gpos = ref + d - boxsize * torch.round(d / boxsize)
    if cmadjust:
        w = gmass / torch.clamp_min(gmass.sum(1, keepdim=True), 1e-30)
        gpos = gpos - (gpos * w[..., None]).sum(1, keepdim=True)
        gvel = gvel - (gvel * w[..., None]).sum(1, keepdim=True)
    gvel = torch.where(valid[..., None], gvel, 0.0)
    ii = torch.clamp_min(ar[None, :] - nsubs[:, None], 0)
    lat = _lattice(ii, sides[:, None], gpos.dtype)
    corner = torch.where(valid[..., None], gpos, math.inf).amin(
        1, keepdim=True) - 10.0 * spacing
    gpos = torch.where(valid[..., None], gpos, corner - lat * spacing)
    gdens = None if dens is None else torch.where(valid, dens[idx], 1.0)
    return idx, gpos, gvel, gmass, valid, gdens


def _cellsize(opt: C.Options, nsub: int) -> int:
    cellsize = int(max(C.MINCELLSIZE, opt.Ncellfac * nsub))
    return min(cellsize, max(32, nsub // 2))


def _ratios(opt: C.Options, pos, vel, mass, valid, dens, cellsize):
    """R of (B, npad) padded structures of one pad size: their velocity
    density unless ``dens`` replays one, background grid and nearest
    cells.  Returns (R, dens)."""
    if dens is None:
        exact = opt.iLocalVelDenApproxCalcFlag == 0
        dens = torch.stack([localfield.velocity_density(
            pos[b], vel[b], nvel=opt.Nvel, nsearch=opt.Nsearch,
            active=valid[b], exact=exact) for b in range(pos.shape[0])])
    cellpos, gvel, gdispinv, _ = bgfield.background_grid(
        pos, vel, mass, cellsize, gridtype=opt.gridtype)
    return bgfield.denv_ratio(pos, vel, dens, cellpos, gvel, gdispinv,
                              opt.Nsearch), dens


def structure_outliers(opt: C.Options, pos, vel, mass, valid, dens=None):
    """Background grid + velocity density + outlier values of one padded
    structure or a (B, npad) batch of one pad size (reference
    SearchSubSub's per-structure preamble, search.cxx:2631-2649).
    ``dens`` replays a density (the global one, or a cache).  Returns
    (ell (-inf on padded rows), dens, (mode, sdlow, sdhigh))."""
    single = pos.dim() == 2
    if single:
        pos, vel, mass, valid = pos[None], vel[None], mass[None], valid[None]
        dens = None if dens is None else dens[None]
    R, dens = _ratios(opt, pos, vel, mass, valid, dens,
                      _cellsize(opt, int(valid[0].sum())))
    ell, stats = bgfield.outlier_values(R, mass, active=valid)
    ell = torch.where(valid, ell, -math.inf)
    if single:
        return ell[0], dens[0], tuple(s[0] for s in stats)
    return ell, dens, stats


# ---------------------------------------------------------------------------
# Merger cores (reference search.cxx:1530-1816, HaloCoreGrowth:1817)
# ---------------------------------------------------------------------------

# (row, core slot, 6 x 6) elements a growth step gathers at once
_GROW_ELEMS = 1 << 22


def _core_ellx(opt: C.Options, sublevel: int) -> float:
    """The core search's loop-0 linking length at a recursion level."""
    return opt.ellxscale * opt.ellphys * opt.ellhalophysfac * \
        opt.halocorexfac * opt.halocorexfac ** (sublevel - 1)


def _row_sums(values: torch.Tensor, key: torch.Tensor, nkeys: int
              ) -> torch.Tensor:
    """(nkeys, m) sums of the (n, m) ``values`` over the rows of each
    ``key`` (non-decreasing): one reduction that adds each (key, column)
    in row order, on a card as on the host, so a sum depends on its own
    rows alone; the lengths counted with integer adds, no host sync."""
    lengths = torch.zeros(nkeys, dtype=torch.int64,
                          device=key.device).index_add_(
        0, key, torch.ones_like(key))
    return torch.segment_reduce(values, "sum", lengths=lengths, axis=0,
                                unsafe=True)


def _core_sigv2(vel, mass, valid, sid, nseg: int) -> torch.Tensor:
    """(nseg,) float64 velocity dispersion (1D average, reference
    HaloSigmaV) of each structure's valid rows, float32 ``_row_sums`` over
    its consecutive rows (``sid`` non-decreasing): the same whether the
    structure is searched alone or in a batch."""
    w = torch.where(valid, mass, 0.0)
    s = _row_sums(torch.cat([w[:, None], vel * w[:, None]], 1), sid, nseg)
    mtot = torch.clamp_min(s[:, 0], 1e-30)
    vmean = s[:, 1:] / mtot[:, None]
    s2 = _row_sums((seg.sq3(vel - vmean[sid]) * w)[:, None], sid, nseg)
    return (s2[:, 0] / mtot / 3.0).double()


def _f32(x: float, dev) -> torch.Tensor:
    """``x`` as a 0-d float32 tensor, filled on ``dev``."""
    return torch.full((), x, dtype=torch.float32, device=dev)


def _core_moments(key, w, phase, nkeys: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each core's mass-weighted phase mean (nkeys, 6) and the lower
    Cholesky factor (nkeys, 6, 6) of its dispersion tensor plus 1e-6 of
    its mean diagonal; rows sorted by core (``key`` non-decreasing),
    ``_row_sums``: no float atomics."""
    s = _row_sums(torch.cat([w[:, None], phase * w[:, None]], 1), key,
                  nkeys)
    msum = torch.clamp_min(s[:, 0], 1e-30)
    mu = s[:, 1:] / msum[:, None]
    d = phase - mu[key]
    outer = d[:, :, None] * d[:, None, :] * w[:, None, None]
    cov = _row_sums(outer.reshape(-1, 36), key, nkeys).view(nkeys, 6, 6) / \
        msum[:, None, None]
    diag = torch.diagonal(cov, dim1=1, dim2=2)
    tr = diag[:, 0]
    for i in range(1, 6):
        tr = tr + diag[:, i]
    eye = torch.eye(6, dtype=cov.dtype, device=cov.device)
    cov = cov + (1e-6 * torch.clamp_min(tr / 6.0, 1e-20))[:, None, None] * eye
    return mu, _cholesky6(cov)


def _cholesky6(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., 6, 6) symmetric positive definite
    matrices in elementwise operations: l_ij = (a_ij - sum_k<j l_ik l_jk)
    / l_jj, the k in order.  An entry depends on its own matrix alone, in
    any batch: a library factorisation may change its algorithm with the
    batch's size."""
    cols = []
    for j in range(6):
        s = a[..., j:, j]
        for k in range(j):
            s = s - cols[k][..., j - k:] * cols[k][..., j - k, None]
        d = torch.sqrt(s[..., :1])
        cols.append(torch.cat([d, s[..., 1:] / d], -1))
    out = torch.zeros_like(a)
    for j in range(6):
        out[..., j:, j] = cols[j]
    return out


def _phase_distance(dd: torch.Tensor, chol: torch.Tensor) -> torch.Tensor:
    """dd^T cov^-1 dd over the last axis of the (..., 6) differences, with
    ``chol`` (..., 6, 6) the factor of cov: |y|^2 for L y = dd, solved and
    summed in one order, elementwise, so an element does not depend on
    the shapes around it."""
    y = []
    for k in range(6):
        s = dd[..., k]
        for j in range(k):
            s = s - chol[..., k, j] * y[j]
        y.append(s / chol[..., k, k])
    md = y[0] * y[0]
    for k in range(1, 6):
        md = md + y[k] * y[k]
    return md


def search_cores_batch(opt: C.Options, entries: List[dict], level: int,
                       pair_budget: Optional[int] = None
                       ) -> List[Tuple[torch.Tensor, int]]:
    """The merger-core search (reference search.cxx:1530-1816 and
    HaloCoreGrowth:1817) of many structures at once (one structure is a
    batch of one): per entry (``search_sub_sub``'s, ``sub`` set by the
    subset search) its (int64 core ids in its row order, ncores).  Core 1
    is the main core, 2..ncores merger remnants to promote (reference
    iHaloCoreSearch = 2): 6DFOF between the untagged rows with a length
    that changes by ``halocorexfaciter`` a loop, then the phase-tensor
    growth.

    One cell sort of every structure's rows keyed by (structure, cell),
    each on its own grid over its padded bounds at the longest length of
    the loops (``fof.segmented_cells``), and one pair table there, which
    every loop cuts by its own length; then batches of whole structures
    whose candidate slots fit ``pair_budget`` (default ``_pair_budget``),
    one fetch of the per-structure totals setting them.  Each batch runs
    ``_cores_batch`` in a ``cores.batch`` span.  A structure's ids do not
    depend on the others in its batch: the velocity scale's segment sums,
    the link's tensor divisions and the growth's elementwise Cholesky
    factor and distance round the same in any batch."""
    if not entries:
        return []
    dev = entries[0]["ppos"].device
    nsub = [int(e["nsub"]) for e in entries]

    def rows(key):
        return torch.cat([e[key][:e["nsub"]] for e in entries])

    pos, vel, mass, valid = (rows(k) for k in
                             ("ppos", "pvel", "pmass", "valid"))
    sub = rows("sub").long()
    ellx = _core_ellx(opt, level)
    ellx2 = [ellx * ellx]                      # each loop's squared length
    for _ in range(1, max(1, opt.halocorenumloops)):
        ellx2.append(ellx2[-1] * opt.halocorexfaciter ** 2)
    cells = fof.segmented_cells(pos, nsub, [e["bounds"] for e in entries],
                                math.sqrt(max(ellx2)))
    sigv2 = _core_sigv2(vel, mass, valid, cells.seg, len(entries))
    totals = fetch_small(cells.candidates())
    out = []
    for k0, k1 in _budget_runs(totals, pair_budget or _pair_budget(dev)):
        r0, r1 = int(cells.starts[k0]), int(cells.starts[k1])
        with span("cores.batch", structures=k1 - k0, rows=r1 - r0) as b:
            core, ncores, loops, sweeps = _cores_batch(
                opt, cells, pos[r0:r1], vel[r0:r1], mass[r0:r1],
                valid[r0:r1], sub[r0:r1], sigv2[k0:k1], k0, k1, ellx2,
                level)
            b.set(loops=loops, sweeps=sweeps)
        for k in range(k0, k1):
            a = int(cells.starts[k]) - r0
            out.append((core[a:a + nsub[k]], int(ncores[k - k0])))
    return out


def _cores_batch(opt: C.Options, cells: fof.SegmentedCells, pos, vel, mass,
                 valid, sub, sigv2, k0: int, k1: int, ellx2: List[float],
                 level: int):
    """The core search of structures k0..k1-1 (``pos`` ... ``sub``: their
    rows; ``ellx2``: each loop's squared length), each structure's
    velocity scale, ``minsize``, cores and a live flag on the device.
    The pairs within the longest length once; each loop the 6D links
    between the live structures' eligible rows, one label fixed point
    over their union, one renumbering by size per structure (ties by the
    row within the structure, each its own ``minsize``), the core
    bookkeeping, and one fetch of the live count.  A structure stops when
    a loop finds no core or ``minsize`` is about to reach its rows, and
    keeps its cores.  Then one fetch of the core counts and the growth of
    the structures with two or more.  Returns
    (core ids in row order, host ncores, loops, fixed-point sweeps)."""
    dev = pos.device
    nseg = k1 - k0
    r0, r1 = int(cells.starts[k0]), int(cells.starts[k1])
    n = r1 - r0
    sid = cells.seg[r0:r1] - k0                # structure of each row
    order = cells.order[r0:r1] - r0            # sorted -> original row
    ones = torch.ones_like(sid)
    counts = torch.zeros(nseg, dtype=torch.int64,
                         device=dev).index_add_(0, sid, ones)
    src = order - (torch.cumsum(counts, 0) - counts)[sid]
    loops = sweeps = 0
    with span("cores.fof"):
        b2 = max(ellx2)
        erow, ecol, d2 = cells.pairs(r0, r1, math.sqrt(b2), b2=b2)
        vel_s = vel[order]
        dv2 = seg.sq3(vel_s[erow] - vel_s[ecol])
        eseg = sid[erow]
        untagged = (valid & (sub == 0))[order]
        nvalid = torch.zeros(nseg, dtype=torch.int64,
                             device=dev).index_add_(0, sid, valid.long())
        minsize = torch.clamp_min(
            (nvalid.double() * opt.halocorenfac *
             opt.halocorenumfaciter ** (level - 1)).long(), opt.MinSize)
        ellv2 = sigv2 * opt.halocorevfac ** 2
        core = torch.zeros(n, dtype=torch.int64, device=dev)   # sorted rows
        ncores = torch.zeros(nseg, dtype=torch.int64, device=dev)
        live = torch.ones(nseg, dtype=torch.bool, device=dev)
        for loop in range(max(1, opt.halocorenumloops)):
            loops += 1
            elig = untagged & live[sid]
            if loop > 0:
                elig = elig & (core == 1)
            v2 = torch.clamp_min(ellv2, 1e-30).float()
            ok = _core_link(d2, dv2, _f32(ellx2[loop], dev), v2[eseg]) & \
                elig[erow] & elig[ecol]
            # a link that fails is a self-link: no compaction, no sync
            labels, nsw = fof.fof_labels_from_edges(
                erow, torch.where(ok, ecol, erow), n, undirected=True,
                with_sweeps=True)
            sweeps += nsw
            sizes = torch.zeros(n, dtype=torch.int64,
                                device=dev).index_add_(0, labels, ones)
            min_src = torch.full((n,), BIG_I32, dtype=torch.int64,
                                 device=dev).scatter_reduce_(
                0, labels, src, "amin")
            _, local, ngc = seg.renumber_segments(
                sid, sizes, min_src,
                (sizes >= torch.clamp_min(minsize, 1)[sid]) & live[sid],
                nseg)
            pfc = local[labels]
            upd = live & (ngc > 0)
            if loop == 0:
                new, nc_new = pfc, ngc
            else:
                # the refined main core replaces core 1; extra groups
                # append
                new = torch.where((core == 1) & (pfc == 0), 0, core)
                new = torch.where(pfc == 1, 1, new)
                new = torch.where(pfc > 1, pfc - 1 + ncores[sid], new)
                nc_new = ncores + torch.clamp_min(ngc - 1, 0)
            core = torch.where(upd[sid], new, core)
            ncores = torch.where(upd, nc_new, ncores)
            ellv2 = ellv2 * opt.halocorevfaciter ** 2
            shrunk = torch.clamp_min(
                (minsize.double() * opt.halocorenumfaciter).long(),
                opt.MinSize)
            minsize = torch.where(upd, shrunk, minsize)
            live = upd & (shrunk.double() * opt.halocorenumfaciter <
                          nvalid.double())
            if not bool(live.any()):
                break
        ncores = torch.where(ncores >= 2, ncores, 0)
        nc_h = fetch_small(ncores)
        core = torch.where(ncores[sid] > 0, _scatter_back(core, order), 0)
    if opt.iHaloCoreSearch >= 2 and opt.iPhaseCoreGrowth and nc_h.any():
        with span("cores.growth"):
            core = _phase_tensor_growth_batch(
                pos, vel, mass, valid, sub, core, sid, ncores,
                int(nc_h.max()), int((nc_h + 1).sum()))
    return core, nc_h, loops, sweeps


def _phase_tensor_growth_batch(pos, vel, mass, valid, pfof_sub, core, sid,
                               ncores, ncmax: int, nkeys: int,
                               iters: int = 4) -> torch.Tensor:
    """Untagged halo particles join the core of least Mahalanobis phase
    distance, the cores' phase means and dispersion tensors recomputed
    each of ``iters`` steps (``_core_moments``, ``_phase_distance``), for
    many structures at once: rows consecutive by structure (``sid``),
    ``ncores`` per structure (0 where it takes no growth; its rows stay
    0).  Cores keyed (structure, core),
    one stable sort and one set of segment sums a step, each row's
    distance to its own structure's cores only (padded to ``ncmax`` at
    +inf), the lowest core id on a tie."""
    dev = pos.device
    n = pos.shape[0]
    phase = torch.cat([pos, vel], 1)
    nc_row = ncores[sid]
    assignable = valid & (pfof_sub == 0) & (nc_row > 0)
    base = (torch.cumsum(ncores + 1, 0) - (ncores + 1))[sid]
    cid = torch.arange(1, ncmax + 1, device=dev)
    pad = cid[None, :] > nc_row[:, None]
    slots = torch.where(pad, base[:, None], base[:, None] + cid[None, :])
    chunk = max(1, _GROW_ELEMS // (ncmax * 36))
    core = core.long()
    for _ in range(iters):
        w = torch.where((core > 0) & valid, mass, 0.0)
        key = base + core
        order = torch.argsort(key, stable=True)
        mu, chol = _core_moments(key[order], w[order], phase[order], nkeys)
        best = []
        for a in range(0, n, chunk):
            sl = slots[a:a + chunk]
            md = _phase_distance(phase[a:a + chunk, None, :] - mu[sl],
                                 chol[sl])
            best.append(torch.argmin(
                torch.where(pad[a:a + chunk], math.inf, md), 1) + 1)
        core = torch.where(assignable, torch.cat(best), core)
    return core


# ---------------------------------------------------------------------------
# The recursion (reference SearchSubSub, search.cxx:2480-2946)
# ---------------------------------------------------------------------------

_B_ELEMS = 1 << 22   # padded rows per batched outlier pass


def _rank_remap(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each positive id's 1-based rank among the distinct positive ids
    (0 elsewhere), and the distinct count (a 0-d tensor)."""
    u = torch.unique(ids[ids > 0])
    r = torch.searchsorted(u, ids) + 1
    return torch.where(ids > 0, r, 0), torch.tensor(u.shape[0],
                                                    device=ids.device)


def _global_density(opt: C.Options, pos, vel, act, spacing: float,
                    mesh=None, boxsize: Optional[float] = None):
    """The velocity density of the ``act`` particles (those in structures
    of MINSUBSIZE members or more), computed once (reference
    search.cxx:214-240) on their compacted rows padded to a power of two
    with a lattice of isolated points, or replayed from ``opt.smname``
    (reference Read/WriteLocalVelocityDensity, io.cxx:178-251).  With a
    ``mesh``, the approximative mode and at least ``DIST_DENSITY_MIN``
    active particles, it is computed over the shards' x-slabs.  Returns
    the (n,) density, 0 elsewhere, or None when no particle is active."""
    n = pos.shape[0]
    aidx = torch.nonzero(act).squeeze(1)
    nact = int(aidx.shape[0])
    if nact == 0:
        return None
    aidx_h = aidx.cpu().numpy() if opt.smname else None
    loaded = cache_io.read_local_velocity_density(opt.smname, aidx_h) \
        if opt.smname else None
    dens = torch.zeros(n, dtype=pos.dtype, device=pos.device)
    if loaded is not None and len(loaded) == nact:
        dens[aidx] = torch.from_numpy(np.asarray(loaded, np.float32)).to(
            pos.device)
        return dens
    npadg = _next_pow2(nact)
    side = int(np.ceil(max(npadg - nact, 1) ** (1 / 3)))
    gpos, gvel = pos[aidx], vel[aidx]
    ii = torch.arange(npadg - nact, device=pos.device)
    lat = _lattice(ii, torch.tensor(side, device=pos.device), pos.dtype)
    corner = gpos.amin(0) - 10.0 * spacing
    gpos = torch.cat([gpos, corner - lat * spacing])
    gvel = torch.cat([gvel, gvel.new_zeros(npadg - nact, 3)])
    avalid = torch.arange(npadg, device=pos.device) < nact
    exact = opt.iLocalVelDenApproxCalcFlag == 0
    if mesh is not None and not exact and \
            nact >= distributed_localfield.DIST_DENSITY_MIN:
        d = distributed_localfield.distributed_velocity_density(
            gpos, gvel, mesh, nvel=opt.Nvel, nsearch=opt.Nsearch,
            active=avalid, boxsize=boxsize)
    else:
        d = localfield.velocity_density(gpos, gvel, nvel=opt.Nvel,
                                        nsearch=opt.Nsearch, active=avalid,
                                        exact=exact)
    dens[aidx] = d[:nact]
    if opt.smname:
        cache_io.write_local_velocity_density(
            opt.smname, d[:nact].cpu().numpy(), aidx_h)
    return dens


def _hostid(parent: np.ndarray) -> np.ndarray:
    """Top-level ancestor of every group (-1 for field objects), by
    pointer jumping (reference GetHierarchy)."""
    ng1 = len(parent)
    anc = np.arange(ng1, dtype=np.int64)
    for _ in range(C.MAXSUBLEVEL + 2):
        nxt = parent[anc]
        stepped = nxt > 0
        if not stepped.any():
            break
        anc = np.where(stepped, nxt, anc)
    hostid = np.where(anc == np.arange(ng1), -1, anc)
    hostid[0] = -1
    return hostid


def search_sub_sub(opt: C.Options, pos, vel, mass, pfof, ngroups: int,
                   boxsize: Optional[float] = None, mesh=None,
                   timings: Optional[Dict[str, float]] = None):
    """Recursive substructure search (reference SearchSubSub).  Returns
    (pfof int64 tensor, ngroups_total, hostid, parent, level), the
    per-group arrays numpy and indexed by group id (entry 0 unused;
    hostid -1 for field objects).  ``timings`` receives the per-phase
    times; the counters ``subsub_level<L>_structures`` (searched),
    ``_candidates`` (before the unbind), ``_found`` and
    ``subsub_cores_promoted`` go to ``utils/telemetry``.  With ``mesh``
    the inputs are on ``mesh.home`` and the work is sharded as the module
    says; the result is that of one device."""
    dev = pos.device if isinstance(pos, torch.Tensor) else torch.device("cpu")

    def as_f32(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=torch.float32)
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    pos, vel, mass = as_f32(pos), as_f32(vel), as_f32(mass)
    # the splice below writes into pfof: always a copy, never the caller's
    # tensor (which .to() returns as it is when it already fits)
    pfof = torch.as_tensor(pfof).to(dev, torch.int64, copy=True)
    laps = timings if timings is not None else {}

    def lap(phase: str):
        return span(f"substructure.{phase}", laps, f"subsub_{phase}",
                    device=dev)

    with lap("density"):
        ng_total = int(ngroups)
        parent = np.zeros(ng_total + 1, np.int64)
        level_of = np.zeros(ng_total + 1, np.int32)
        # pad-lattice pitch beyond every linking length of the search
        spacing = 3.0 * opt.ellxscale * opt.ellphys * max(1.0, opt.ellxfac)
        sizes0_t = seg.group_sizes(pfof, ng_total)
        sizes0 = sizes0_t.cpu().numpy()
        queue = [g for g in range(1, ng_total + 1)
                 if sizes0[g] >= C.MINSUBSIZE]
        dens_global = None
        if opt.iSubSearch and queue and not opt.iHaloLocalDensity:
            act = (pfof > 0) & (sizes0_t[pfof] >= C.MINSUBSIZE)
            dens_global = _global_density(opt, pos, vel, act, spacing, mesh,
                                          boxsize)

    cores_on = opt.iHaloCoreSearch > 0
    for level in range(1, C.MAXSUBLEVEL + 1):
        if not queue or not opt.iSubSearch:
            break
        with span("substructure.level", level=level) as lvl:
            with lap("prep"):
                lvl_order = torch.argsort(pfof, stable=True)
                offs = torch.searchsorted(
                    pfof[lvl_order],
                    torch.arange(ng_total + 2, device=dev)).cpu().numpy()
                prep = []
                for g in queue:
                    nsub = int(offs[g + 1] - offs[g])
                    if nsub < C.MINSUBSIZE:
                        continue
                    npad = _next_pow2(nsub)
                    prep.append({
                        "g": g, "start": int(offs[g]), "nsub": nsub,
                        "npad": npad, "cellsize": _cellsize(opt, nsub),
                        "side": int(np.ceil(max(npad - nsub, 1) ** (1 / 3)))})
                lvl.set(structures=len(prep))
                telemetry.count(f"subsub_level{level}_structures",
                                len(prep))
                _prep_level(opt, prep, pos, vel, mass, dens_global,
                            lvl_order, boxsize, spacing)
            with lap("outliers"):
                _outliers_level(opt, prep)
            if mesh is not None:
                from ..parallel.distributed_substructure import \
                    distributed_structure_search

                with lap("cores"):
                    distributed_structure_search(opt, prep, level, cores_on,
                                                 mesh)
            else:
                with lap("subset"):
                    search_subset_batch(opt, prep)
                with lap("cores"):
                    search_level_cores(opt, prep, level, cores_on)
            with lap("unbind"):
                pend = [e for e in prep if e["ng_sub"] > 0]
                telemetry.count(f"subsub_level{level}_candidates",
                                sum(e["ng_sub"] for e in pend))
                if pend and opt.uinfo.unbindflag:
                    _unbind_level(opt, pend)
            with lap("splice"):
                pend = [e for e in pend if e["ng_sub"] > 0]
                queue = []
                if pend:
                    ngmax = max(e["ng_sub"] for e in pend)
                    sizes_h = torch.stack([seg.group_sizes(e["sub"], ngmax)
                                           for e in pend]).cpu().numpy()
                for j, e in enumerate(pend):
                    g, ng_sub = e["g"], e["ng_sub"]
                    sel = e["sub"] > 0
                    pfof[e["idx"][:e["nsub"]][sel]] = ng_total + e["sub"][sel]
                    parent = np.concatenate(
                        [parent, np.full(ng_sub, g, np.int64)])
                    level_of = np.concatenate(
                        [level_of, np.full(ng_sub, level, np.int32)])
                    queue.extend(ng_total + s for s in range(1, ng_sub + 1)
                                 if sizes_h[j][s] >= C.MINSUBSIZE)
                    ng_total += ng_sub
                telemetry.count(f"subsub_level{level}_found",
                                sum(e["ng_sub"] for e in pend))
                for e in prep:
                    e.clear()
    return pfof, ng_total, _hostid(parent), parent, level_of


def _prep_level(opt: C.Options, prep: List[dict], pos, vel, mass,
                dens_global, lvl_order, boxsize, spacing: float) -> None:
    """Padded contexts of a level's structures, one batched build per pad
    size; each entry gains its rows (``idx``), padded arrays, the cached
    density (None in halo-local mode) and its padded bounds."""
    dev = pos.device
    by_npad: Dict[int, List[dict]] = {}
    for e in prep:
        by_npad.setdefault(e["npad"], []).append(e)
    for npad, grp in by_npad.items():
        def col(key):
            return torch.tensor([e[key] for e in grp], device=dev)
        idx, ppos, pvel, pmass, valid, dens = _prep_class(
            pos, vel, mass, dens_global, lvl_order, col("start"),
            col("nsub"), col("side"), npad, float(boxsize or 0.0), spacing,
            bool(opt.icmrefadjust))
        lohi = torch.stack([ppos.amin(1), ppos.amax(1)], 1).double().cpu()
        for j, e in enumerate(grp):
            e.update(idx=idx[j], ppos=ppos[j], pvel=pvel[j], pmass=pmass[j],
                     valid=valid[j], cached=None if dens is None else dens[j],
                     bounds=(lohi[j, 0].numpy(), lohi[j, 1].numpy()))


def _outliers_level(opt: C.Options, prep: List[dict]) -> None:
    """Outlier values of a level's structures: R batched over structures
    of one pad size and grid depth (the reference's buckets), then one
    host fit for every structure that takes one."""
    buckets: Dict[tuple, List[dict]] = {}
    for e in prep:
        key = (e["npad"], bgfield.grid_levels(e["npad"], e["cellsize"]))
        buckets.setdefault(key, []).append(e)
    batches = []
    for (npad, _), entries in buckets.items():
        bmax = max(1, _B_ELEMS // npad)
        for lo in range(0, len(entries), bmax):
            grp = entries[lo:lo + bmax]
            valid = torch.stack([e["valid"] for e in grp])
            mass = torch.stack([e["pmass"] for e in grp])
            cached = grp[0]["cached"]
            R, _ = _ratios(opt, torch.stack([e["ppos"] for e in grp]),
                           torch.stack([e["pvel"] for e in grp]), mass, valid,
                           None if cached is None else
                           torch.stack([e["cached"] for e in grp]),
                           grp[0]["cellsize"])
            batches.append((grp, R, valid,
                            bgfield.distribution(R, mass, valid)))
    bgfield.refine([b[3] for b in batches])
    for grp, R, valid, dist in batches:
        ell = torch.where(valid, bgfield.normalise(R, *dist[:3]), -math.inf)
        for j, e in enumerate(grp):
            e["ell"] = ell[j]


def search_level_cores(opt: C.Options, entries: List[dict], level: int,
                       cores_on: bool) -> None:
    """The merger-core lap of a level's structures (``search_sub_sub``'s
    entries, ``sub`` set by the subset search): the core search of them
    all in ``search_cores_batch`` (none with the search off or past
    ``maxnlevelcoresearch``), then each structure's promotion and host
    merges (``_cores_and_merges``)."""
    found: List[Optional[Tuple[torch.Tensor, int]]] = [None] * len(entries)
    if entries and cores_on and level <= opt.maxnlevelcoresearch:
        found = search_cores_batch(opt, entries, level)
    for e, f in zip(entries, found):
        _cores_and_merges(opt, e, level, f)


def _cores_and_merges(opt: C.Options, e: dict, level: int,
                      found: Optional[Tuple[torch.Tensor, int]]) -> None:
    """One structure's merger cores ``found`` (core ids, ncores) by
    ``search_cores_batch``, None where no core search ran: cores beyond
    the main one become substructures after its subset groups; then the
    phase merges (``coresubmergemindist`` > 0) on the host."""
    with span("substructure.cores.structure", g=e.get("g"),
              nsub=e["nsub"], level=level):
        nsub, ng_sub, sub = e["nsub"], e["ng_sub"], e["sub"]
        ppos, pvel, pmass = (e[k][:nsub]
                             for k in ("ppos", "pvel", "pmass"))
        host = None

        def host_arrays():
            return tuple(a.cpu().numpy() for a in (ppos, pvel, pmass))

        if found is not None and found[1] >= 2:
            core, ncores = found
            extra = (core > 1) & (sub == 0)
            sub = torch.where(extra, core - 1 + ng_sub, sub)
            ncore_extra = ncores - 1
            if opt.coresubmergemindist > 0 and ng_sub > 0:
                with span("cores.merge"):
                    host = host_arrays()
                    sub_np, ncore_extra = merge_substructures_cores_phase(
                        *host, sub.cpu().numpy(), ng_sub, ncore_extra,
                        opt.coresubmergemindist)
                    sub = torch.from_numpy(
                        sub_np.astype(np.int64)).to(sub.device)
            telemetry.count("subsub_cores_promoted", ncore_extra)
            ng_sub += ncore_extra
        if opt.coresubmergemindist > 0 and ng_sub > 1:
            with span("cores.merge"):
                host = host or host_arrays()
                sub_np, ns_new, nc_new = merge_substructures_phase(
                    *host, sub.cpu().numpy(), ng_sub, 0,
                    opt.coresubmergemindist)
                sub = torch.from_numpy(sub_np.astype(np.int64)).to(
                    sub.device)
            ng_sub = ns_new + nc_new
        e["sub"], e["ng_sub"] = sub, int(ng_sub)


def _unbind_level(opt: C.Options, pend: List[dict]) -> None:
    """One unbind over every candidate of a level: the structures' rows
    concatenate into one problem with their group ids offset, and each
    structure's surviving ids are ranked back to 1..k (its groups keep
    their relative size order under the global renumbering).  The
    reference concatenates the padded rows; their count sets the
    ejection's compaction schedule, so it is passed as ``layout_n``."""
    base = 0
    gids = []
    for e in pend:
        gids.append(torch.where(e["sub"] > 0, e["sub"] + base, 0))
        base += e["ng_sub"]
    cat = [torch.cat([e[k][:e["nsub"]] for e in pend])
           for k in ("ppos", "pvel", "pmass")]
    ures = unbind_mod.check_unbound_groups(
        *cat, torch.cat(gids), base, opt.uinfo, opt.G, min_size=opt.MinSize,
        layout_n=sum(e["npad"] for e in pend))
    off, ks = 0, []
    for e in pend:
        e["sub"], k = _rank_remap(ures.pfof[off:off + e["nsub"]])
        off += e["nsub"]
        ks.append(k)
    for e, k in zip(pend, torch.stack(ks).cpu().tolist()):
        e["ng_sub"] = int(k)
