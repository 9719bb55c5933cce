"""The property stage's segmented sums (velociraptor_stf_tpu_torch/kernels/
moments.py, csrc/segment_moments.cu) against ``ops/segments.py``'s sums.

On the CPU the wrapper runs its plain version in float32, the parent's
``seg.segment_sum`` rounding: every column equals those sums bit for bit.
In float64 (what the kernel computes) it holds to a float64 brute force,
and the property stage built on it holds to the float32 one within the
float32 sums' own error: a sequential float32 sum of n terms is within
n 2^-24 of the sum of their magnitudes, so a centre moves by up to
n 2^-24 |x| (1e-5 of a halo's radius at these sizes); where a radius cut
or a profile bin then moves one particle, the counts differ by one and
the quantities over the cut by that particle's share.  A group's sums
depend on its own rows only (the mesh's condition), and the stage calls
no ``torch.bincount`` and none of ``seg``'s sums.

This file imports no jax, so the GPU tests run on a machine without it:

    python -m pytest tests/test_torch_moments.py --noconftest -q -s

(``-s`` shows the card test's widest change per property key.)  Without a
CUDA device the ``gpu`` tests skip.
"""

import numpy as np
import pytest
import torch

from velociraptor_stf_tpu_torch.kernels import moments as MK
from velociraptor_stf_tpu_torch.models import properties as P
from velociraptor_stf_tpu_torch.ops import segments as seg
from velociraptor_stf_tpu_torch.utils import config as C
from velociraptor_stf_tpu_torch.utils import telemetry
from torch_threads import one_torch_thread  # noqa: F401

# gas, dark matter, low-resolution dark matter, star, black hole
TYPES = np.array([0, 1, 2, 4, 5])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def hydro_groups(seed=0, ngroups=24, box=20.0):
    """Group-sorted particles of ``ngroups`` clumps (group ids 1..ngroups,
    some untagged rows first): sizes 1 to 600 with a one-member group, a
    group of dark matter alone and an id with no members; every type, the
    hydro fields (half the gas star-forming), potentials."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(20, 600, ngroups)
    sizes[3] = 1
    sizes[7] = 0                       # an id with no members
    pos, vel, typ, gid = [], [], [], []
    for g, s in enumerate(sizes, start=1):
        c = rng.uniform(1.0, box - 1.0, 3)
        r = rng.uniform(0.05, 0.4)
        pos.append(c + rng.normal(0.0, r, (s, 3)))
        vel.append(rng.normal(0.0, 80.0, 3) + rng.normal(0.0, 60.0, (s, 3)))
        t = rng.choice(TYPES, s, p=[0.35, 0.45, 0.05, 0.12, 0.03])
        if g == 5:
            t[:] = 1                   # dark matter alone
        typ.append(t)
        gid.append(np.full(s, g))
    n0 = 50                            # untagged
    pos = np.concatenate([rng.uniform(0, box, (n0, 3))] + pos)
    vel = np.concatenate([rng.normal(0, 60.0, (n0, 3))] + vel)
    ptype = np.concatenate([rng.choice(TYPES, n0)] + typ)
    pfof = np.concatenate([np.zeros(n0, np.int64)] + gid)
    n = len(pfof)
    mass = np.where(ptype == 1, 1.0, rng.uniform(0.1, 0.3, n))
    mass = np.where(ptype == 2, 4.0, mass)
    mass = np.where(ptype == 5, rng.uniform(1.0, 3.0, n), mass)
    f32 = np.float32
    out = dict(pos=pos.astype(f32), vel=vel.astype(f32),
               mass=mass.astype(f32), pfof=pfof, ptype=ptype,
               u=rng.uniform(10.0, 1e3, n).astype(f32),
               sfr=np.where(rng.random(n) < 0.5, rng.uniform(0, 1, n),
                            0.0).astype(f32),
               zmet=rng.uniform(0.0, 0.03, n).astype(f32),
               tage=rng.uniform(0.0, 1.0, n).astype(f32),
               bhmdot=rng.uniform(0.0, 0.1, n).astype(f32),
               W=-rng.uniform(1e3, 1e5, n).astype(f32))
    return {k: torch.from_numpy(v) for k, v in out.items()}, ngroups


def options(frame=C.PROPREFCM, iterate=0):
    opt = C.Options()
    opt.G = 43.0211349
    opt.iPropertyReferencePosition = frame
    opt.iIterateCM = iterate
    opt.lengthtokpc = 1000.0
    opt.iaperturecalc = 1
    opt.aperture_values_kpc = [30.0, 100.0]
    opt.aperture_proj_values_kpc = [50.0]
    opt.iprofilecalc = 1
    opt.profile_bin_edges = [-2.0, -1.5, -1.0, -0.5, 0.0, 0.3]
    opt.iprofilenorm = 0
    opt.iextrahalooutput = 1
    opt.SOthresholds_values_crit = [500.0, 2500.0]
    return opt


def bundle(d, ng, opt, device="cpu", **kw):
    t = {k: v.to(device) for k, v in d.items()}
    return P.property_bundle(
        opt, t["pos"], t["vel"], t["mass"], t["pfof"], ng, W=t["W"],
        ptype=t["ptype"], boxsize=kw.pop("boxsize", None), pertype=True,
        u=t["u"], sfr=t["sfr"], zmet=t["zmet"], tage=t["tage"],
        bhmdot=t["bhmdot"], **kw)


def selections(d, ng):
    """(rows, offsets, sel, tabs, centre, uvel, axis) of a pass over the
    hydro rows with five fields: every type, a radius cut and all tagged
    rows, about each group's first member, a velocity and an axis."""
    pfof = d["pfof"]
    offsets = seg.group_offsets(pfof, ng)
    rows = P._rows(d["pos"], d["vel"], d["mass"], d["u"], d["sfr"],
                   d["zmet"], d["tage"], d["bhmdot"])
    first = torch.clamp(offsets[:-1], max=len(pfof) - 1)
    c = d["pos"][first].double() + 0.01
    u = d["vel"][first].double()
    a = torch.nn.functional.normalize(
        u + torch.tensor([30.0, -20.0, 10.0], dtype=torch.float64), dim=1)
    tagged = pfof > 0
    dx = d["pos"] - c.float()[pfof]
    sel = torch.stack([(d["ptype"] == t) & tagged for t in TYPES] +
                      [tagged, tagged & (seg.sq3(dx) < 0.04)], 1)
    S = sel.shape[1]
    tabs = [(1, 1 + s % 2, s % 2) for s in range(S)]
    zero = torch.zeros(1, ng + 1, 3, dtype=torch.float64)
    centre = torch.cat([zero, c[None]])
    uvel = torch.cat([zero, u[None], 2.0 * u[None]])
    axis = torch.cat([zero, a[None]])
    return rows, 5, offsets, sel, tabs, centre, uvel, axis


def test_plain_float32_sums_equal_segment_sums():
    """The CPU path's columns are ``seg``'s float32 sums bit for bit:
    counts, masses, first moments, angular momenta, the outer products and
    the fields, for every selection (empty and one-member groups among
    them)."""
    d, ng = hydro_groups()
    rows, nf, offsets, sel, tabs, centre, uvel, axis = selections(d, ng)
    got = MK.segment_moments(rows, nf, offsets, sel, tabs, centre, uvel,
                             axis)
    assert got.dtype == torch.float64 and got.shape == (
        sel.shape[1], ng + 1, MK.columns(nf))
    pfof, ng1 = d["pfof"], ng + 1
    pos, vel, m = d["pos"], d["vel"], d["mass"]
    for s, (ci, ui, ai) in enumerate(tabs):
        w = torch.where(sel[:, s], m, 0.0)
        dx = pos - centre[ci].float()[pfof]
        dv = vel - uvel[ui].float()[pfof]
        want = {
            MK.COUNT: seg.segment_count(sel[:, s], pfof, ng1),
            MK.M: seg.segment_sum(w, pfof, ng1, presorted=True),
            MK.MX: seg.segment_sum(pos * w[:, None], pfof, ng1,
                                   presorted=True),
            MK.MV: seg.segment_sum(vel * w[:, None], pfof, ng1,
                                   presorted=True),
            MK.ML: seg.segment_sum(torch.linalg.cross(dx, dv) * w[:, None],
                                   pfof, ng1, presorted=True),
            MK.MV2: seg.segment_sum(seg.sq3(dv) * w, pfof, ng1,
                                    presorted=True),
        }
        for col, v in want.items():
            k = 1 if v.dim() == 1 else 3
            assert torch.equal(got[s, :, col:col + k].squeeze(1),
                               v.to(torch.float64)), (s, col)
        iu = (0, 1, 2, 4, 5, 8)
        for col, (a, b) in ((MK.MXX, (dx, dx)), (MK.MVV, (dv, dv))):
            outer = seg.segment_outer(a, b, w, pfof, ng1, presorted=True)
            assert torch.equal(got[s, :, col:col + 6],
                               outer.view(ng1, 9)[:, iu].double()), (s, col)
        for j, f in enumerate(("u", "sfr", "zmet", "tage", "bhmdot")):
            fv = d[f]
            for wt, col in ((torch.where(sel[:, s], fv, 0.0), 0),
                            (fv * w, 1)):
                assert torch.equal(
                    got[s, :, MK.BASE + 2 * j + col],
                    seg.segment_sum(wt, pfof, ng1, presorted=True).double())


def test_plain_float64_sums_match_brute_force():
    """In float64 (what the kernel computes) every column of every group
    against a float64 numpy loop over the group's members, rel 1e-12 of
    the column's largest magnitude."""
    d, ng = hydro_groups(seed=1)
    rows, nf, offsets, sel, tabs, centre, uvel, axis = selections(d, ng)
    got = MK.segment_moments_ref(rows, nf, offsets, sel, tabs, centre,
                                 uvel, axis).numpy()
    r = rows.double().numpy()
    off = offsets.numpy()
    want = np.zeros_like(got)
    for s, (ci, ui, ai) in enumerate(tabs):
        for g in range(ng + 1):
            idx = np.arange(off[g], off[g + 1])
            idx = idx[sel[idx, s].numpy()]
            x, v, m = r[idx, :3], r[idx, 3:6], r[idx, 6]
            dx = x - centre[ci, g].numpy()
            dv = v - uvel[ui, g].numpy()
            a = axis[ai, g].numpy()
            L = np.cross(dx, dv)
            jz, da = L @ a, dx @ a
            rp2 = np.maximum((dx * dx).sum(1) - da * da, 1e-30)
            iu = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
            cols = [np.full(len(idx), 1.0), m, *(m * x.T), *(m * v.T),
                    *(m * L.T), *[dx[:, i] * dx[:, j] * m for i, j in iu],
                    *[dv[:, i] * dv[:, j] * m for i, j in iu],
                    m * (dv * dv).sum(1), 0.5 * m * jz * jz / rp2]
            for j in range(nf):
                f = r[idx, 7 + j]
                cols += [f, m * f]
            want[s, g] = [c.sum() for c in cols]
    scale = np.abs(want).max(axis=(0, 1), keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-12 * np.maximum(scale, 1e-300))


# keys whose value is a sum over the group's members, or those of a type
# (no radius cut): float64 against float32 sums within their error
_MEMBER_SUMS = {"num", "gmass", "Epot", "Zmet_star", "t_mean_star",
                "acc_bh", "n_interloper", "M_interloper"} | {
    f"{q}_{t}" for t in ("gas", "gas_sf", "gas_nsf", "star", "bh")
    for q in ("n", "M", "cmvel", "Temp", "Temp_mean", "SFR", "SFR_mean",
              "Zmet")}


_SO_RADII = ("gRvir", "gR200c", "gR200m", "gR500c", "gRBN98", "SO_radius")


def newton_settled(vv):
    """True where cNFW does not come from the reference's Newton iteration
    (VmaxVvir2 outside (1.05, 36]), or where that iteration, run in
    float64, has settled (tests/test_torch_properties.py)."""
    vv = np.asarray(vv, np.float64)
    c = np.full(vv.shape, 10.0)
    last = []
    for _ in range(31):
        conec = c / (1.0 + c)
        y = vv - 0.216 * c / (np.log1p(c) - c / (1.0 + c))
        dy = 0.216 * conec * conec / np.maximum(c, 1e-6)
        c = np.clip(c + y / np.maximum(dy, 1e-12), 1.0, 1000.0)
        last = [last[-1], c] if last else [c]
    newton = (vv > 1.05) & (vv <= 36.0)
    return ~newton | (np.abs(last[1] - last[0]) <= 1e-4 * last[1])


def _scoped(k):
    """Keys summed over a radius cut about the centre (or a profile bin):
    a member at the cut's edge goes in or out with an ulp of the centre."""
    return k.endswith(("_rvmax", "_30kpc", "_50kpc", "_interloper")) and \
        k != "M_interloper" or k.startswith(
            ("M_200", "M_500", "M_BN98", "L_200", "L_500", "L_BN98",
             "Aperture_mass", "Projected_aperture", "Mass_profile"))


def _one_member(d, ng, props):
    """Per group, the largest mass and the largest |m dx x dv| (about the
    group's centre and mean velocity) of one member: what a cut moves when
    that member crosses it."""
    pfof = d["pfof"]
    dx = d["pos"].double() - torch.from_numpy(props["gcm"]).double()[pfof]
    dv = d["vel"].double() - torch.from_numpy(
        props["gcmvel"]).double()[pfof]
    m = d["mass"].double()
    L = m * torch.linalg.norm(dx, dim=1) * torch.linalg.norm(dv, dim=1)
    return tuple(np.maximum(seg.segment_max(v, pfof, ng + 1).numpy(), 0.0)
                 for v in (m, L))


@pytest.mark.parametrize("frame", [C.PROPREFCM, C.PROPREFMBP,
                                   C.PROPREFMINPOT])
@pytest.mark.parametrize("iterate", [0, 1])
def test_float64_property_stage_within_float32(frame, iterate, monkeypatch):
    """``property_bundle`` with the float64 sums the kernel computes
    against the CPU path's float32 ones (``seg``'s, as the first test
    shows): the same keys, shapes and dtypes, and

    * counts exact, but those over a radius cut or in a profile bin,
      which differ by one member at most;
    * the member sums (no radius cut) within rel 1e-5: groups of up to
      600, n 2^-24 = 3.6e-5 of the magnitudes, whose sums run within a
      third of the result;
    * what is summed over a radius cut or in a profile bin within one
      member's mass (angular momenta: one member's |m dx x dv|) and rel
      1e-5: the centre moves by the float32 sums' error, and a member at
      the edge of a cut goes in or out;
    * every other float key within rel 1e-3 of its largest value on the
      groups whose SO radii agree to 1e-4 and whose cut counts are equal
      (R_Vmax is a member's own radius: the RVmax block where that count
      is equal), at least half of the groups (a quarter with RVmax).
      As tests/test_torch_properties.py: cNFW where the Newton iteration
      settles; eigenvectors up to sign.  Shapes and Krot of a type with
      fewer than 20 members in a group (the black holes) are left out:
      r^2 - (x.j)^2 cancels near the axis, and a few points have
      near-equal eigenvalues.
    """
    d, ng = hydro_groups(seed=2)
    opt = options(frame, iterate)
    want = {k: v.numpy() for k, v in bundle(d, ng, opt).items()}
    ref = MK.segment_moments_ref
    monkeypatch.setattr(MK, "segment_moments",
                        lambda *a: ref(*a, acc=torch.float64))
    got = {k: v.numpy() for k, v in bundle(d, ng, opt).items()}
    assert list(got) == list(want)
    cut_counts = [k for k in want if k in ("RVmax_npart", "Npart_profile")
                  or k.startswith("Aperture_npart")]
    same = np.ones(ng + 1, bool)
    for k in cut_counts:
        diff = np.abs(got[k].astype(np.int64) - want[k]).reshape(ng + 1, -1)
        assert diff.max() <= 1, k
        if k != "RVmax_npart":
            same &= (diff == 0).all(1)
    for k in _SO_RADII:
        g, w = got[k].reshape(ng + 1, -1), want[k].reshape(ng + 1, -1)
        same &= (np.isclose(g, w, rtol=1e-4, atol=0.0) | (g == w)).all(1)
    rv_same = same & (got["RVmax_npart"] == want["RVmax_npart"])
    assert same[1:].mean() >= 0.5 and rv_same[1:].mean() >= 0.25
    settled = newton_settled(want["VmaxVvir2"])
    m1, L1 = _one_member(d, ng, want)
    for k in want:
        g, w = got[k], want[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if np.issubdtype(w.dtype, np.integer):
            if k not in cut_counts:
                np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        g, w = g.astype(np.float64), w.astype(np.float64)
        top = np.abs(w[np.isfinite(w)]).max(initial=0.0)
        if k in _MEMBER_SUMS:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * top,
                                       err_msg=k)
            continue
        if _scoped(k):
            one = (L1 if k.startswith("L_") else m1).reshape(
                (-1,) + (1,) * (w.ndim - 1))
            assert (np.abs(g - w) <= one + 1e-5 * np.abs(w)).all(), k
            continue
        rows = (rv_same if k.startswith("RVmax_") else same).copy()
        if k == "cNFW":
            rows &= settled
        tname = k.split("_", 1)[-1]
        if k.startswith(("Krot_", "q_", "s_", "eigvec_")) and \
                f"n_{tname}" in want:
            rows &= want[f"n_{tname}"] >= 20
        if "eigvec" in k:
            # each eigenvector (column) up to its sign
            sign = np.sign(np.sum(g * w, axis=-2, keepdims=True))
            g = g * np.where(sign == 0, 1.0, sign)
        np.testing.assert_allclose(g[rows], w[rows], rtol=1e-3,
                                   atol=1e-3 * top, err_msg=k)


def _shifted(d, ng, extra):
    """``d`` with ``extra`` groups of other rows put before its groups
    (their ids first), and the id of its group g in the result."""
    e, ne = hydro_groups(seed=9, ngroups=extra)
    tagged_e = e["pfof"] > 0
    out = {}
    for k in d:
        a, b = e[k][tagged_e], d[k]
        if k == "pfof":
            b = torch.where(b > 0, b + ne, 0)
        out[k] = torch.cat([b[b == 0] if k == "pfof" else b[d["pfof"] == 0],
                            a, b[d["pfof"] > 0]])
    return out, ng + ne, ne


@pytest.mark.parametrize("acc", [torch.float32, torch.float64])
def test_group_sums_do_not_depend_on_other_groups(acc):
    """A group's sums are the same bits when other groups' rows are put
    before it (a shard's block against the whole set)."""
    d, ng = hydro_groups(seed=4)
    one = MK.segment_moments_ref(*selections(d, ng), acc=acc)
    d2, ng2, ne = _shifted(d, ng, 9)
    two = MK.segment_moments_ref(*selections(d2, ng2), acc=acc)
    # the selections' tables differ only by the groups put first
    assert torch.equal(two[:, ne + 1:], one[:, 1:])


_BANNED = ("segment_sum", "segment_mean", "segment_outer", "segment_count",
           "group_sizes")


def _run_without_segment_sums(monkeypatch, device):
    d, ng = hydro_groups(seed=5)

    def banned(*a, **k):
        raise AssertionError("the property stage called a banned sum")

    for name in _BANNED:
        monkeypatch.setattr(seg, name, banned)
    monkeypatch.setattr(torch, "bincount", banned)
    telemetry.reset()
    out = bundle(d, ng, options(C.PROPREFMBP, 1), device=device,
                 boxsize=20.0)
    counts = telemetry.snapshot()
    return out, counts


def test_property_stage_calls_no_bincount_or_segment_sums(monkeypatch):
    """The whole stage (every block, the shrinking sphere, a periodic
    box) without ``torch.bincount`` and ``seg``'s sums; the counters
    show its passes and selections."""
    _, counts = _run_without_segment_sums(monkeypatch, "cpu")
    # P0, the MBP frame, the shrinking sphere's rounds and its last
    # sphere, K1, K2, A, B
    assert counts["props_moment_passes"] >= 8
    assert counts["props_moment_selections"] > 60


@pytest.mark.gpu
def test_cuda_property_stage_calls_no_bincount_or_segment_sums(
        cuda, monkeypatch):
    from velociraptor_stf_tpu_torch import kernels

    kernels.reset_launches()
    _, counts = _run_without_segment_sums(monkeypatch, cuda)
    assert kernels.LAUNCHES["segment_moments"] == \
        counts["props_moment_passes"] > 0
    assert counts["props_moment_selections"] > 60


def _hydro_shape_pass(device, seed=6):
    """A pass A at the hydro cell's shapes: 678 groups of 167,898 rows,
    50 selections, five fields."""
    g = torch.Generator().manual_seed(seed)
    ng, n = 678, 167_898
    pfof = torch.sort(torch.randint(0, ng + 1, (n,), generator=g))[0]
    pos = torch.rand(n, 3, generator=g) * 12.5
    vel = torch.randn(n, 3, generator=g) * 100.0
    mass = torch.rand(n, generator=g) + 0.5
    fields = [torch.rand(n, generator=g) for _ in range(5)]
    rows = P._rows(pos, vel, mass, *fields)
    offsets = seg.group_offsets(pfof, ng)
    sel = torch.rand(n, 50, generator=g) < 0.4
    tabs = [(s % 2, s % 3, s % 2) for s in range(50)]
    tab = torch.randn(3, ng + 1, 3, generator=g, dtype=torch.float64)
    args = (rows, 5, offsets, sel, tabs, tab[:2], tab,
            torch.nn.functional.normalize(tab[:2], dim=-1))
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                 for a in args)


@pytest.mark.gpu
def test_cuda_segment_moments_match_plain_and_repeat(cuda):
    """The kernel at the hydro cell's shapes against the float64 plain
    version (rel 1e-9 of each column's largest magnitude: the same
    products, summed in another order) and bit-equal on a second run;
    one launch."""
    from velociraptor_stf_tpu_torch import kernels

    args = _hydro_shape_pass(cuda)
    kernels.reset_launches()
    got = MK.segment_moments(*args)
    assert kernels.LAUNCHES["segment_moments"] == 1
    again = MK.segment_moments(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = MK.segment_moments_ref(*args)
    scale = want.abs().amax(dim=(0, 1), keepdim=True)
    assert bool(((got - want).abs() <= 1e-9 * scale).all())


@pytest.mark.gpu
def test_cuda_property_stage_against_float32_sums(cuda, capsys):
    """One hydro catalog's property stage on the card (float64 sums)
    against the CPU path's float32 ones (the previous sums): the widest
    relative change of each key, printed; counts of each type equal; the
    counters and the launch count non-zero."""
    from velociraptor_stf_tpu_torch import kernels

    d, ng = hydro_groups(seed=7, ngroups=200)
    opt = options(C.PROPREFCM, 1)
    want = {k: v.numpy() for k, v in bundle(d, ng, opt).items()}
    kernels.reset_launches()
    telemetry.reset()
    got = {k: v.cpu().numpy() for k, v in bundle(d, ng, opt,
                                                 device=cuda).items()}
    assert kernels.LAUNCHES["segment_moments"] > 0
    assert telemetry.snapshot()["props_moment_passes"] > 0
    assert list(got) == list(want)
    rows = []
    for k in want:
        g, w = got[k].astype(np.float64), want[k].astype(np.float64)
        fin = np.isfinite(w)
        assert np.array_equal(g[~fin], w[~fin]), k
        rel = np.abs(g - w)[fin] / max(np.abs(w[fin]).max(initial=0.0),
                                       1e-300)
        rows.append((float(rel.max(initial=0.0)), k))
        if k.startswith("n_") or k == "num":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with capsys.disabled():
        print("\nwidest change of each key on the card against float32 "
              "sums (over its largest value):")
        for r, k in sorted(rows, reverse=True):
            print(f"  {k}: {r:.3e}")
