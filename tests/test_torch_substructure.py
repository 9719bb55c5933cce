"""The port's substructure search stages (velociraptor_stf_tpu_torch/models/
substructure.py) against the JAX package's on the same inputs: the
significance filter, the subset search (``search_subset_batch`` of one
structure, against the JAX per-structure ``search_subset``) for every
FoF_search_type with and without the iterative pass, the fmerge link merge
through the whole search and the sparse pair counts.  The discrete stages
get the JAX package's own outlier values, so the group ids must be exactly
equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from velociraptor_stf_tpu.models import substructure as JS
from velociraptor_stf_tpu.ops import segments as jseg
from velociraptor_stf_tpu.utils import config as C

from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.io.synthetic import host_with_subhalo
from velociraptor_stf_tpu_torch.models import substructure as TS
from velociraptor_stf_tpu_torch.ops import segments as tseg

from test_merging import _two_fragments
from torch_threads import one_torch_thread  # noqa: F401

FOFTYPES = [C.FOFSTPROB, C.FOFSTNOSUBSET, C.FOFSTPROBNN, C.FOFSTPROBLX,
            C.FOFSTPROBNNLX, C.FOFSTPROBNNNODIST, C.FOFSTPROBSCALEELL,
            C.FOFSTPROBSCALEELLNN, C.FOF6DSUBSET]


def _opts(foftype=C.FOFSTPROB, iiterflag=1):
    """tests/test_substructure.py's search options."""
    opt = C.Options()
    opt.ellphys = 0.2
    opt.ellxscale = 0.25
    opt.iiterflag = iiterflag
    opt.ellthreshold = 2.5
    opt.Vratio = 2.0
    opt.thetaopen = 0.10
    opt.ellfac = 1.0
    opt.MinSize = 20
    opt.foftype = foftype
    return opt


def _t(a):
    return torch.from_numpy(np.array(a))


def _alone(opt, pos, vel, mass, ell, bounds=None, npad=None):
    """``search_subset_batch`` of one structure: (int64 ids, group count).
    ``bounds`` default to the rows' extent, the grid the JAX search takes
    without bounds; ``npad`` to the row count."""
    p = _t(pos)
    b = p.double()
    e = {"ppos": p, "pvel": _t(vel), "pmass": _t(mass), "ell": _t(ell),
         "nsub": len(pos), "npad": npad or len(pos),
         "bounds": bounds or (b.amin(0).numpy(), b.amax(0).numpy())}
    TS.search_subset_batch(opt, [e])
    assert e["sub"].dtype == torch.int64
    return e["sub"], e["ng_sub"]


@pytest.fixture(scope="module")
def structure():
    """A planted subhalo and the JAX package's outlier values of it."""
    pos, vel, mass, member = host_with_subhalo(seed=5, nhost=3000, nsub=400)
    valid = np.ones(len(pos), bool)
    ell, _, _ = JS.structure_outliers(_opts(), pos, vel, mass, valid)
    return pos, vel, mass, member, np.asarray(ell)


@pytest.fixture(scope="module")
def jax_subsets(structure):
    """The JAX search, once per criterion class (the foftypes that
    subset_predicate maps to one criterion give one search)."""
    pos, vel, mass, _, ell = structure
    done: dict = {}

    def get(foftype, iiterflag):
        opt = _opts(foftype, iiterflag)
        key = (type(JS.subset_predicate(opt, 1.0, 2.0, 0.5, 2.5)).__name__,
               iiterflag)
        if key not in done:
            pfof, ng = JS.search_subset(opt, jnp.asarray(pos),
                                        jnp.asarray(vel), jnp.asarray(mass),
                                        jnp.asarray(ell))
            done[key] = (np.asarray(pfof), ng)
        return done[key]
    return get


@pytest.mark.parametrize("iiterflag", [0, 1])
@pytest.mark.parametrize("foftype", FOFTYPES)
def test_search_subset_matches_reference(structure, jax_subsets, foftype,
                                         iiterflag):
    """Every criterion, single pass and iterative (attach, merge, relaxed
    attach), the batch of one exactly the JAX package's ids."""
    pos, vel, mass, member, ell = structure
    want, ng_want = jax_subsets(foftype, iiterflag)
    got, ng = _alone(convert.options(_opts(foftype, iiterflag)), pos, vel,
                     mass, ell)
    assert ng == ng_want
    np.testing.assert_array_equal(got.numpy(), want)
    if foftype == C.FOFSTPROB:
        assert ng >= 1 and ((got.numpy() == 1) & member).sum() > 100


def test_search_subset_padded_normalisations(structure):
    """ScaleEll and FOF6DSUBSET normalise by the mean mass and velocity
    variance of the reference's padded rows: the port's batch of one given
    the valid rows and ``npad`` equals the JAX search over the padded
    structure."""
    pos, vel, mass, _, ell = structure
    npad = 8192
    ppos, pvel, pmass, valid = JS._pad_structure(pos, vel, mass, npad, 0.15)
    pell = np.where(valid, np.pad(ell, (0, npad - len(ell))), -np.inf)
    bounds = (ppos.min(0).astype(np.float64), ppos.max(0).astype(np.float64))
    for foftype in (C.FOFSTPROBSCALEELL, C.FOF6DSUBSET):
        opt = _opts(foftype, 0)
        want, ng_want = JS.search_subset(
            opt, jnp.asarray(ppos), jnp.asarray(pvel), jnp.asarray(pmass),
            jnp.asarray(pell.astype(np.float32)), bounds=bounds)
        got, ng = _alone(convert.options(opt), pos, vel, mass, ell,
                         bounds=bounds, npad=npad)
        assert ng == ng_want
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want)[:len(pos)])


def test_significance_filter_matches_reference():
    """Top-ell prefixes kept, groups under MinSize dissolved; -inf and
    untagged rows ignored."""
    rng = np.random.default_rng(4)
    n, ng = 4000, 24
    ell = rng.normal(2.0, 1.2, n).astype(np.float32)
    ell[rng.random(n) < 0.05] = -np.inf
    pfof = rng.integers(0, ng + 1, n).astype(np.int32)
    pfof[:300] = 3                       # one large strong group
    ell[:300] = rng.normal(4.0, 0.5, 300)
    for thr, sig, minsize in ((2.5, 1.0, 20), (1.5, 2.0, 40)):
        want = np.asarray(JS.significance_filter(
            jnp.asarray(ell), jnp.asarray(pfof), 32, thr, sig, minsize))
        got = TS.significance_filter(_t(ell), _t(pfof).long(), 32, thr, sig,
                                     minsize)
        np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).sum() > 300


@pytest.mark.parametrize("sep,foftype", [(0.08, C.FOFSTPROB),
                                         (5.0, C.FOFSTPROB),
                                         (0.08, C.FOFSTPROBNNNODIST)])
def test_link_merge_through_the_search_matches_reference(sep, foftype):
    """tests/test_merging.py's fragments, joined and apart, through the
    iterative search, whose link merge runs on the shared table (for
    FOFSTPROBNNNODIST beside a first pass over the stencil): the batch of
    one gives the JAX per-structure search's ids."""
    rng = np.random.default_rng(0)
    opt = C.Options()
    opt.ellxscale, opt.ellphys = 1.0, 0.05
    opt.Vratio, opt.thetaopen = 1.25, 0.05
    opt.ellthreshold, opt.ellfac, opt.fmerge = 1.0, 0.8, 0.25
    opt.iiterflag, opt.foftype = 1, foftype
    pos, vel = _two_fragments(rng, sep=sep)
    mass = np.ones(len(pos), np.float32)
    ell = np.full(len(pos), 2.0, np.float32)
    want, ng_want = JS.search_subset(opt, jnp.asarray(pos), jnp.asarray(vel),
                                     jnp.asarray(mass), jnp.asarray(ell))
    got, ng = _alone(convert.options(opt), pos, vel, mass, ell)
    assert ng == ng_want
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ng == (1 if sep < 1 else 2)


def test_pair_counts_sparse_matches_reference():
    """``pair_counts``, the subset batch's link counts, against the JAX
    package's ``pair_counts_sparse``."""
    rng = np.random.default_rng(3)
    ng, m = 57, 5000
    gi = rng.integers(0, ng + 1, m).astype(np.int32)
    gj = rng.integers(0, ng + 1, m).astype(np.int32)
    mask = (gi > 0) & (gj > 0) & (gi != gj) & (rng.random(m) < 0.7)
    want = jseg.pair_counts_sparse(gi, gj, mask)
    key, *got = tseg.pair_counts(_t(gi), _t(gj), _t(mask))
    assert key is None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _, *empty = tseg.pair_counts(_t(gi), _t(gj), _t(np.zeros(m, bool)))
    assert all(len(a) == 0 for a in empty)


def test_predicates_match_reference():
    """The nine pair criteria on random pairs, both orientations."""
    rng = np.random.default_rng(8)
    k = 20000
    own = {"vel": rng.normal(0, 50, (k, 3)), "ell": rng.normal(2.5, 1, k),
           "pos": rng.normal(0, 0.02, (k, 3)), "mass": rng.uniform(1, 2, k),
           "scal": rng.uniform(2e4, 9e4, k), "elig": rng.integers(0, 2, k)}
    nbr = {key: v[rng.permutation(k)] for key, v in own.items()}
    nbr["vel"] = own["vel"] * rng.uniform(0.4, 2.5, (k, 1)) + \
        rng.normal(0, 5, (k, 3))
    own = {key: v.astype(np.float32 if v.dtype.kind == "f" else np.int32)
           for key, v in own.items()}
    nbr = {key: v.astype(own[key].dtype) for key, v in nbr.items()}
    d2 = np.sum((own["pos"] - nbr["pos"]) ** 2, -1).astype(np.float32)
    args = {"StreamPred": (0.002, 2.0, 0.95, 2.5),
            "StreamPredAttach": (0.002, 2.0, 0.95, 2.5),
            "StreamPredNoProb": (0.002, 2.0, 0.95),
            "StreamPredNoDist": (2.0, 0.95, 2.5),
            "StreamPredLX": (0.002, 2.0, 0.95, 2.5),
            "StreamPredScaleEllB": (0.002, 2.0, 0.95, 2.5),
            "Pred6DOutlierB": (0.002, 2.5),
            "Pred6DBackground": (0.002, 5e4, 2.5),
            "Pred6DCore": (0.002, 5e4)}
    for name, a in args.items():
        jp, tp = getattr(JS, name)(*a), getattr(TS, name)(*a)
        # ``scal`` is a reference mass in ScaleEllB, a velocity scale^2 in
        # Pred6DOutlierB
        f = 3e-5 if name == "StreamPredScaleEllB" else 1.0
        o1 = dict(own, scal=own["scal"] * np.float32(f))
        b1 = dict(nbr, scal=nbr["scal"] * np.float32(f))
        for o, b in ((o1, b1), (b1, o1)):
            want = np.asarray(jp(jnp.asarray(d2),
                                 {k_: jnp.asarray(v) for k_, v in o.items()},
                                 {k_: jnp.asarray(v) for k_, v in b.items()}))
            got = tp(_t(d2), {k_: _t(v) for k_, v in o.items()},
                     {k_: _t(v) for k_, v in b.items()}).numpy()
            np.testing.assert_array_equal(got, want, err_msg=name)
            assert 0.01 < want.mean() < 0.99, (name, want.mean())
