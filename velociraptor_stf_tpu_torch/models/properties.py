"""Bulk halo properties by segment reductions (port of
velociraptor_stf_tpu/models/properties.py: ``compute_properties``
(``_props_geom`` + ``_props_kin``), ``compute_aperture_properties``,
``compute_rvmax_properties``, ``compute_pertype_properties``,
``compute_energies`` and ``property_bundle``).

Every public function sorts its particles by group once (stably, so each
group keeps its members' order) and works on the group-sorted arrays.
Per-group arrays have num_groups + 1 rows, row 0 being the untagged
particles.

The stage's sums come from ``kernels/moments.py::segment_moments``: one
launch a dependent pass (``_Pass``) sums every selection -- particle type,
sub-type, radius scope, aperture, profile bin -- and every column, in
float64 over the float32 rows, a group's sums from its own rows only, so
that they are the same on every run and in a shard's block
(``parallel/distributed_props.py``).  The passes, in their order of
dependence: the totals and centre of mass (P0), each shrinking-sphere
round, the core block's moments about the centre (K1) and its rotation
about its angular momentum (K2); then, over the snapshot's positions,
every block's sums about the centre (pass A: per type, interlopers,
scopes, apertures, profiles, RVmax, energies) and those about each
selection's own mean velocity and axis (pass B).  The blocks are
generators (``_run_blocks``) that add their selections to each pass in
turn.  The radius-sorted cumulative crossings (SO, half-mass radii) stay
float64 cumulative sums; maxima and minima stay scatter reductions.  The
reference's ``jax.lax.while_loop`` (shrinking sphere) is a host loop with
one ``.any()`` per round; its jitted padding classes are gone.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from ..kernels import moments as MK
from ..ops import segments as seg
from ..utils import config as C
from ..utils import telemetry

PROPCMMINNUM = 10  # reference allvars.h:253

Props = Dict[str, torch.Tensor]


def _f(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``x`` in ``like``'s dtype and device."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _rows(pos, vel, m, *fields) -> torch.Tensor:
    """(n, 7 + nf) float32 rows x y z vx vy vz m, then the fields."""
    return torch.cat([pos, vel, m[:, None]] + [f[:, None] for f in fields],
                     1).float().contiguous()


def _sym(c: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric tensors of (..., 6) columns xx xy xz yy yz
    zz."""
    return torch.stack([c[..., k] for k in (0, 1, 2, 1, 3, 4, 2, 4, 5)],
                       -1).unflatten(-1, (3, 3))


def _vec(s: torch.Tensor, col: int) -> torch.Tensor:
    return s[..., col:col + 3]


def _per(s: torch.Tensor, col: int, den: torch.Tensor) -> torch.Tensor:
    """The 3-vector columns ``col`` of sums ``s`` over the clamped sums
    ``den``, in float64."""
    return _vec(s, col) / torch.clamp_min(den, 1e-30)[..., None]


class _Pass:
    """The selections of one dependent pass over the same group-sorted
    rows, summed in one launch (``kernels/moments.py``).  ``add`` takes
    (n,) or (n, k) bool masks and what they are summed about: a centre
    ``c`` and velocity reference ``u`` and axis ``a``, each (ng1, 3)
    shared by the k selections or (k, ng1, 3) one each, none for zeros;
    it returns the selections' slice of ``sums`` (S, ng1, K), which
    ``run`` fills.  ``names``: the fields that follow the rows' first 7
    columns."""

    def __init__(self, rows: torch.Tensor, offsets: torch.Tensor,
                 names: Sequence[str] = ()):
        self.rows, self.offsets, self.names = rows, offsets, tuple(names)
        self._masks: List[torch.Tensor] = []
        self._tabs: List[Tuple[int, int, int]] = []
        # per kind (c, u, a): (k, ng1, 3) tables, entry 0 the zeros
        zero = torch.zeros(1, offsets.shape[0] - 1, 3, dtype=torch.float64,
                           device=rows.device)
        self._tables: Tuple[list, list, list] = ([zero], [zero], [zero])
        self._seen: Dict[Tuple[int, int], int] = {}
        self.sums: Optional[torch.Tensor] = None

    def field(self, name: str) -> int:
        """Column of the plain sum of field ``name`` (+ 1: mass-weighted)."""
        return MK.BASE + 2 * self.names.index(name)

    def _index(self, kind: int, t: Optional[torch.Tensor],
               k: int) -> List[int]:
        lst = self._tables[kind]
        if t is None:
            return [0] * k
        if t.dim() == 2:
            key = (kind, id(t))
            if key not in self._seen:
                self._seen[key] = sum(x.shape[0] for x in lst)
                lst.append(t[None])
            return [self._seen[key]] * k
        base = sum(x.shape[0] for x in lst)
        lst.append(t)
        return list(range(base, base + k))

    def add(self, mask: torch.Tensor, c=None, u=None, a=None) -> slice:
        mask = mask[:, None] if mask.dim() == 1 else mask
        k = mask.shape[1]
        idx = [self._index(i, t, k) for i, t in enumerate((c, u, a))]
        s0 = len(self._tabs)
        self._masks.append(mask)
        self._tabs += list(zip(*idx))
        return slice(s0, s0 + k)

    def run(self) -> None:
        if not self._tabs:
            return
        tables = [(torch.cat(lst) if len(lst) > 1 else lst[0]).double()
                  for lst in self._tables]
        sel = torch.cat(self._masks, 1) if len(self._masks) > 1 else \
            self._masks[0].contiguous()
        self.sums = MK.segment_moments(self.rows, len(self.names),
                                       self.offsets, sel, self._tabs,
                                       *tables)
        S = len(self._tabs)
        telemetry.count("props_moment_passes", -(-S // MK.MAX_SEL))
        telemetry.count("props_moment_selections", S)


def _sums(rows: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor,
          **about) -> torch.Tensor:
    """(ng1, K) sums of one selection: a pass of its own."""
    p = _Pass(rows, offsets)
    i = p.add(mask, **about)
    p.run()
    return p.sums[i][0]


def _run_blocks(blocks: Iterable, passes: Sequence[_Pass]) -> List[Props]:
    """Drive generator blocks through dependent passes together: each block
    adds its selections to pass k before its k-th ``yield`` and reads the
    pass's sums after it; returns each block's result."""
    blocks = list(blocks)
    for p in passes:
        for b in blocks:
            next(b)
        p.run()
    out = []
    for b in blocks:
        try:
            next(b)
        except StopIteration as stop:
            out.append(stop.value)
        else:
            raise RuntimeError("a property block yields once per pass")
    return out


def _zero_row0(props: Props, ng1: int) -> Props:
    """Row 0 (the untagged particles) of every array set to 0: the arrays
    of a dtype are copied into one buffer whose row-0 elements are cleared
    in one launch, and each comes back as a view of it."""
    out: Props = {}
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for k, v in props.items():
        by_dtype.setdefault(v.dtype, []).append(k)
    for keys in by_dtype.values():
        vs = [props[k] for k in keys]
        flat = torch.cat([v.reshape(-1) for v in vs])
        row0, o = [], 0
        for v in vs:
            row0 += range(o, o + v.numel() // ng1)
            o += v.numel()
        flat.index_fill_(0, torch.tensor(row0, device=flat.device), 0)
        o = 0
        for k, v in zip(keys, vs):
            out[k] = flat[o:o + v.numel()].view(v.shape)
            o += v.numel()
    return {k: out[k] for k in props}


def _above_half(cum64: torch.Tensor, g_s: torch.Tensor, rows: torch.Tensor,
                ng1: int, strict: bool = True) -> torch.Tensor:
    """``rows`` whose float64 cumulative mass ``cum64`` (group-sorted,
    non-decreasing in each group) exceeds (``strict``) or reaches half the
    total over ``rows`` of their group.  The comparison stays in float64,
    where the sums of float32 masses are exact, so a cumulative mass equal
    to half the total is a tie that breaks the same way on every device
    and in every layout (F5, ROADMAP queue 3)."""
    half = 0.5 * torch.clamp_min(
        seg.segment_max(torch.where(rows, cum64, 0.0), g_s, ng1), 0.0)
    return ((cum64 > half[g_s]) if strict else (cum64 >= half[g_s])) & rows


def _first_crossing(cond: torch.Tensor, g_s: torch.Tensor,
                    ng1: int) -> torch.Tensor:
    """Per group: smallest sorted index where ``cond`` holds, else n."""
    n = cond.shape[0]
    idx = torch.arange(n, device=cond.device)
    return seg.segment_min(torch.where(cond, idx, n), g_s, ng1)


def group_sorted(pfof: torch.Tensor, *arrays: Optional[torch.Tensor]):
    """(pfof, *arrays) permuted stably into group order (None stays
    None)."""
    perm = seg.sort_by_group(pfof)
    return (pfof[perm],) + tuple(None if a is None else a[perm]
                                 for a in arrays)


def _eig_shape(iten: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(q, s, eigenvectors) of (ng1, 3, 3) mass distribution tensors;
    eigenvalues ascending, as ``jnp.linalg.eigh`` returns them."""
    evals, evecs = torch.linalg.eigh(iten)
    lam = torch.clamp_min(evals[:, 2], 1e-30)
    return (torch.sqrt(evals[:, 1] / lam),
            torch.sqrt(torch.clamp_min(evals[:, 0], 0.0) / lam), evecs)


def _sigma(disp: torch.Tensor) -> torch.Tensor:
    """det(disp)^(1/6) of (..., 3, 3) tensors, computed in float64 and
    rounded once.  The determinant is the cofactor expansion, element by
    element: a batched LU (``torch.linalg.det``) rounds a matrix
    differently with the batch it is in, and the CPU's vectorised float32
    ``pow`` differs from its scalar tail, so either would make a group's
    value depend on how many groups a shard holds."""
    a = disp.double()
    det = a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] -
                          a[..., 1, 2] * a[..., 2, 1]) - \
        a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] -
                        a[..., 1, 2] * a[..., 2, 0]) + \
        a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] -
                        a[..., 1, 1] * a[..., 2, 0])
    return torch.pow(torch.clamp_min(det, 1e-30), 1.0 / 6.0).to(disp.dtype)


def compute_properties(pos, vel, mass, pfof, num_groups: int, **kw
                       ) -> Props:
    """Geometry (CM, radius sort, SO, Vmax, half-mass radius) then
    kinematics (dispersion, J, Krot, shape, cNFW) of groups
    1..num_groups.  Keywords as the reference's ``_props_geom``."""
    refpos = kw.pop("refpos", None)
    refvel = kw.pop("refvel", None)
    pfof, pos, vel, mass = group_sorted(pfof, pos, vel, mass)
    return _properties(pos, vel, mass, pfof, num_groups, refpos=refpos,
                       refvel=refvel, **kw)


def _properties(pos, vel, mass, pfof, num_groups, *, G=43.0211349,
                calc_shape=True, **kw) -> Props:
    props, ref, vref, rows, offsets, gsize = _props_geom(
        pos, vel, mass, pfof, num_groups, G=G, **kw)
    return _props_kin(rows, offsets, pfof, num_groups, props, ref, vref,
                      gsize, G=G, calc_shape=calc_shape)


def _props_geom(pos, vel, mass, pfof, num_groups: int, *,
                G: float = 43.0211349, boxsize: Optional[float] = None,
                rhocrit: float = 1.0, rhobg: float = 1.0,
                virlevel: float = 200.0, virBN98: float = 97.0,
                so_thresholds: Sequence[float] = (), min_size: int = 20,
                so_minhalofac: float = 0.05, iIterateCM: bool = False,
                cmfrac: float = 0.1, cmadjustfac: float = 0.7,
                refpos: Optional[torch.Tensor] = None,
                refvel: Optional[torch.Tensor] = None):
    """Mass, CM (optionally by shrinking spheres), SO masses and radii,
    Vmax, half-mass radius of group-sorted particles; also the rows
    (unwrapped positions) and group offsets the core block sums over."""
    n = pos.shape[0]
    ng1 = num_groups + 1
    dtype = pos.dtype
    m = mass if mass.dim() == 1 else torch.full((n,), float(mass),
                                                device=pos.device)
    if boxsize:
        pos = seg.unwrap_positions(pos, pfof, boxsize, num_groups)
    tagged = pfof > 0
    offsets = seg.group_offsets(pfof, num_groups)
    rows = _rows(pos, vel, m)

    num = offsets[1:] - offsets[:-1]
    s0 = _sums(rows, offsets, tagged)
    gmass = s0[:, MK.M].to(dtype)
    gcm = _per(s0, MK.MX, s0[:, MK.M]).to(dtype)
    gcmvel = _per(s0, MK.MV, s0[:, MK.M]).to(dtype)

    # shrinking-sphere centre (reference GetCM:60-116)
    r2_all = seg.sq3(pos - gcm[pfof])
    gsize2 = seg.segment_max(torch.where(tagged, r2_all, 0.0), pfof, ng1)
    if iIterateCM:
        fac2 = cmadjustfac ** 2
        gids = torch.arange(ng1, device=pos.device)
        active = (num * cmadjustfac >= PROPCMMINNUM) & (gids > 0)
        cm, ri2, rcmv2 = gcm, gsize2, gsize2
        while bool(active.any()):
            ri2 = ri2 * fac2
            d2 = seg.sq3(pos - cm[pfof])
            inside = (d2 <= ri2[pfof]) & tagged & active[pfof]
            s = _sums(rows, offsets, inside)
            cmnew = _per(s, MK.MX, s[:, MK.M]).to(dtype)
            ok = (s[:, MK.COUNT].long() >=
                  torch.clamp_min(cmfrac * num, PROPCMMINNUM)) & active
            cm = torch.where(ok[:, None], cmnew, cm)
            rcmv2 = torch.where(ok, ri2, rcmv2)
            active = ok
        gcm = cm
        # CM velocity from the particles inside the final sphere
        inside = (seg.sq3(pos - gcm[pfof]) <= rcmv2[pfof]) & tagged
        s = _sums(rows, offsets, inside)
        gcmvel_it = _per(s, MK.MV, s[:, MK.M]).to(dtype)
        it_ok = num * cmadjustfac >= PROPCMMINNUM
        gcmvel = torch.where(it_ok[:, None], gcmvel_it, gcmvel)

    ref = refpos if refpos is not None else gcm
    vref = refvel if refvel is not None else gcmvel

    # radius sort + per-group cumulative mass
    r2 = seg.sq3(pos - ref[pfof])
    perm = seg.lexsort2(r2, pfof)
    g_s = pfof[perm]
    r_s = torch.sqrt(torch.clamp_min(r2[perm], 1e-30))
    m_s = m[perm]
    rank = seg.segment_rank(g_s, offsets)
    Mcum64 = seg.segment_cumsum(m_s.double(), g_s, offsets)
    Mcum = Mcum64.to(m_s.dtype)
    in_s = g_s > 0
    gsize = seg.segment_max(torch.where(in_s, r_s, 0.0), g_s, ng1)
    num_f = num.to(dtype)

    # spherical overdensities (reference :5203)
    fac = torch.log(_f(3.0 / (4.0 * math.pi), pos))
    lnrho = torch.log(torch.clamp_min(Mcum, 1e-30)) - \
        3.0 * torch.log(r_s) + fac
    minnum = torch.clamp_min((so_minhalofac * num_f + 1).long(),
                             int(min_size * so_minhalofac + 1))

    def lnthr(x):
        return torch.log(torch.clamp_min(_f(x, pos), 1e-30))

    thresholds = [
        ("Mvir", "Rvir", lnthr(virlevel * rhobg)),
        ("M200c", "R200c", lnthr(rhocrit * 200.0)),
        ("M200m", "R200m", lnthr(rhobg * 200.0)),
        ("M500c", "R500c", lnthr(rhocrit * 500.0)),
        ("MBN98", "RBN98", lnthr(virBN98 * rhocrit)),
    ] + [(f"SO{i}", f"SOr{i}", lnthr(rhocrit * t))
         for i, t in enumerate(so_thresholds)]

    props: Props = {}
    first_mass = seg.segment_min(torch.where(rank == 0, m_s, math.inf),
                                 g_s, ng1)
    lo = offsets[g_s]
    so_out = {}
    for mname, rname, thr in thresholds:
        cond = (lnrho < thr) & (rank >= minnum[g_s]) & in_s
        k = _first_crossing(cond, g_s, ng1)
        found = k < n
        kc = torch.clamp_max(k, n - 1)
        # the previous sample of the same group (itself at the group start)
        kp = torch.maximum(kc - 1, lo[kc])
        rho_k, rho_p = lnrho[kc], lnrho[kp]
        drho = rho_k - rho_p
        safe = torch.abs(drho) > 1e-12
        gamma1 = torch.where(safe, torch.log(r_s[kc] / r_s[kp]) / drho, 0.0)
        gamma2 = torch.where(safe, torch.log(Mcum[kc] / Mcum[kp]) / drho,
                             0.0)
        delta = thr - rho_k
        Rso = torch.where(found, r_s[kc] * torch.exp(gamma1 * delta), gsize)
        Mso = torch.where(found, Mcum[kc] * torch.exp(gamma2 * delta), gmass)
        # zero below a single particle mass (reference :5305)
        bad = Mso < first_mass
        so_out[mname] = torch.where(bad, 0.0, Mso)
        so_out[rname] = torch.where(bad, 0.0, Rso)
    for key, v in so_out.items():
        if not key.startswith("SO"):
            props["g" + key] = v
    nso = len(so_thresholds)
    empty = torch.zeros((ng1, 0), dtype=dtype, device=pos.device)
    props["SO_mass"] = torch.stack([so_out[f"SO{i}"] for i in range(nso)],
                                   -1) if nso else empty
    props["SO_radius"] = torch.stack([so_out[f"SOr{i}"] for i in range(nso)],
                                     -1) if nso else empty

    # Vmax, Rmax, half-mass radius (reference :370-420)
    vc2 = G * Mcum / r_s
    eligible = (Mcum >= gmass[g_s] /
                torch.sqrt(torch.clamp_min(num_f[g_s], 1.0))) & in_s
    vc2m = torch.where(eligible, vc2, -math.inf)
    gvmax2 = seg.segment_max(vc2m, g_s, ng1)
    kmax = _first_crossing(vc2m == gvmax2[g_s], g_s, ng1)
    kmaxc = torch.clamp_max(kmax, n - 1)
    props["gmaxvel"] = torch.sqrt(torch.clamp_min(gvmax2, 0.0))
    props["gRmaxvel"] = torch.where(kmax < n, r_s[kmaxc], 0.0)
    props["gMmaxvel"] = torch.where(kmax < n, Mcum[kmaxc], 0.0)

    khalf = _first_crossing(_above_half(Mcum64, g_s, in_s, ng1), g_s, ng1)
    props["gRhalfmass"] = torch.where(khalf < n,
                                      r_s[torch.clamp_max(khalf, n - 1)], 0.0)
    k2h = _first_crossing((r_s > 2.0 * props["gRhalfmass"][g_s]) & in_s,
                          g_s, ng1)
    k2c = torch.clamp(k2h - 1, 0, n - 1)
    props["gMassTwiceRhalfmass"] = torch.where(k2h < n, Mcum[k2c], gmass)

    props["num"] = num
    props["gmass"] = gmass
    props["gcm"] = gcm
    props["gcmvel"] = gcmvel
    return props, ref, vref, rows, offsets, gsize


def _props_kin(rows, offsets, pfof, num_groups: int, props: Props, ref,
               vref, gsize, *, G: float, calc_shape: bool = True) -> Props:
    """Dispersion, angular momentum, Krot, shape and NFW concentration
    from the rows (unwrapped positions) of ``_props_geom``."""
    ng1 = num_groups + 1
    dtype = props["gmass"].dtype
    props = dict(props)
    tagged = pfof > 0
    s = _sums(rows, offsets, tagged, c=ref, u=vref)
    msafe = torch.clamp_min(s[:, MK.M], 1e-30)[:, None, None]
    gveldisp = (_sym(s[:, MK.MVV:MK.MVV + 6]) / msafe).to(dtype)
    props["gveldisp"] = gveldisp
    props["gsigma_v"] = _sigma(gveldisp)
    gJ = _vec(s, MK.ML)
    props["gJ"] = gJ.to(dtype)
    ekin = 0.5 * s[:, MK.MV2]
    props["Ekin"] = ekin.to(dtype)

    # rotational support about the gJ axis (reference :430)
    jhat = props["gJ"] / torch.clamp_min(
        torch.sqrt(seg.sq3(props["gJ"])), 1e-30)[:, None]
    krot = _sums(rows, offsets, tagged, c=ref, u=vref, a=jhat)[:, MK.KROT]
    props["Krot"] = (krot / torch.clamp_min(ekin, 1e-30)).to(dtype)

    if calc_shape:
        iten = (_sym(s[:, MK.MXX:MK.MXX + 6]) / msafe).to(dtype)
        props["gq"], props["gs"], props["geigvec"] = _eig_shape(iten)

    # NFW concentration (reference :3656, mycNFW Newton)
    R200c, M200c = props["gR200c"], props["gM200c"]
    vvir2 = G * M200c / torch.clamp_min(R200c, 1e-30)
    VmaxVvir2 = props["gmaxvel"] ** 2 / torch.clamp_min(vvir2, 1e-30)

    def nfw_f(c):
        return 0.216 * c / (torch.log1p(c) - c / (1.0 + c))

    c = torch.full((ng1,), 10.0, dtype=dtype, device=rows.device)
    for _ in range(30):     # Newton on f(c) - VmaxVvir2 = 0
        conec = c / (1.0 + c)
        y = VmaxVvir2 - nfw_f(c)
        dy = 0.216 * conec * conec / torch.clamp_min(c, 1e-6)
        c = torch.clamp(c + y / torch.clamp_min(dy, 1e-12), 1.0, 1000.0)
    rmaxv = torch.clamp_min(props["gRmaxvel"], 1e-30)
    ratio_fallback = torch.where(M200c > 0, R200c / rmaxv, gsize / rmaxv)
    use_newton = (VmaxVvir2 > 1.05) & (VmaxVvir2 <= 36.0)
    props["cNFW"] = torch.where(R200c <= 0, -1.0,
                                torch.where(use_newton, c, ratio_fallback))
    props["VmaxVvir2"] = VmaxVvir2
    props["gsize"] = gsize
    return _zero_row0(props, ng1)


def _passes(pos, vel, mass, pfof, num_groups: int,
            **fields) -> Tuple[_Pass, _Pass]:
    """Passes A and B over the snapshot's group-sorted rows, with the
    fields given (those not None)."""
    present = {k: v for k, v in fields.items() if v is not None}
    offsets = seg.group_offsets(pfof, num_groups)
    A = _Pass(_rows(pos, vel, mass, *present.values()), offsets, present)
    return A, _Pass(A.rows, offsets)


def compute_aperture_properties(pos, vel, mass, pfof, num_groups: int, *,
                                refpos, refvel, **kw) -> Props:
    """Aperture masses, counts, dispersions and half-mass radii, projected
    aperture masses and radial mass profiles (reference
    CalculateApertureQuantities, substructureproperties.cxx:4539)."""
    pfof, pos, vel, mass = group_sorted(pfof, pos, vel, mass)
    A, B = _passes(pos, vel, mass, pfof, num_groups)
    return _run_blocks([_apertures(pos, vel, mass, pfof, num_groups, A, B,
                                   refpos=refpos, refvel=refvel, **kw)],
                       (A, B))[0]


def _apertures(pos, vel, mass, pfof, num_groups: int, A: _Pass, B: _Pass,
               *, refpos, refvel, apertures: Sequence[float] = (),
               apertures_proj: Sequence[float] = (),
               profile_edges: Sequence[float] = (), iprofilenorm: int = 0,
               R200c: Optional[torch.Tensor] = None):
    n = pos.shape[0]
    ng1 = num_groups + 1
    dtype = pos.dtype
    out: Props = {}
    dx = pos - refpos[pfof]
    r2 = seg.sq3(dx)
    ing = pfof > 0

    if apertures:
        # one radius sort serves every aperture's half-mass radius
        perm_r = seg.lexsort2(r2, pfof)
        g_sr = pfof[perm_r]
        r_sr = torch.sqrt(torch.clamp_min(r2[perm_r], 1e-30))
        offs_r = seg.group_offsets(g_sr, num_groups)
        Mcum_r = seg.segment_cumsum(
            torch.where(g_sr > 0, mass[perm_r], 0.0).double(), g_sr, offs_r)
        ap_sel = torch.stack([ing & (r2 < a * a) for a in apertures], 1)
        ia = A.add(ap_sel, c=refpos, u=refvel)
    proj = [ing & (dx[:, i0] ** 2 + dx[:, i1] ** 2 < a * a)
            for a in apertures_proj
            for i0, i1 in ((0, 1), (0, 2), (1, 2))]
    if proj:
        ip = A.add(torch.stack(proj, 1), c=refpos, u=refvel)
    if profile_edges:
        edges = torch.tensor(profile_edges, dtype=dtype, device=pos.device)
        r = torch.sqrt(torch.clamp_min(r2, 1e-30))
        if iprofilenorm == 0 and R200c is not None:
            r = r / torch.clamp_min(R200c[pfof], 1e-30)
        ib = torch.searchsorted(edges, torch.log10(torch.clamp_min(r, 1e-30)))
        nb = len(profile_edges) + 1
        bins = ing[:, None] & (ib[:, None] ==
                               torch.arange(nb, device=pos.device))
        iprof = A.add(bins, c=refpos, u=refvel)
    yield

    if apertures:
        sa = A.sums[ia]
        m_ap = sa[:, :, MK.M]
        # each aperture's dispersion about its own mean velocity
        ib_ = B.add(ap_sel, c=refpos, u=_per(sa, MK.MV, m_ap))
    yield

    for ai, a in enumerate(apertures):
        out[f"Aperture_mass_{ai}"] = m_ap[ai].to(dtype)
        out[f"Aperture_npart_{ai}"] = sa[ai, :, MK.COUNT].long()
        out[f"Aperture_veldisp_{ai}"] = torch.sqrt(torch.clamp_min(
            B.sums[ib_][ai, :, MK.MV2] / torch.clamp_min(m_ap[ai], 1e-30) /
            3.0, 0.0)).to(dtype)
        # reference aperture_rhalfmass, substructureproperties.cxx:4639
        kh = _first_crossing(_above_half(Mcum_r, g_sr, (g_sr > 0) &
                                         (r_sr < a), ng1, strict=False),
                             g_sr, ng1)
        out[f"Aperture_rhalfmass_{ai}"] = torch.where(
            kh < n, r_sr[torch.clamp(kh, 0, n - 1)], 0.0)

    for j in range(len(proj)):
        ai, pi = divmod(j, 3)
        out[f"Projected_aperture_{ai}_mass_proj{pi}"] = \
            A.sums[ip][j, :, MK.M].to(dtype)

    if profile_edges:
        # per (group, bin) sums of each group's own rows: the profile
        # does not change from run to run on a card
        sp = A.sums[iprof]
        out["Mass_profile"] = sp[:, :, MK.M].T.contiguous().to(dtype)
        out["Npart_profile"] = sp[:, :, MK.COUNT].T.contiguous().long()
    return out


def compute_rvmax_properties(pos, vel, mass, pfof, num_groups: int, *,
                             refpos, refvel, rmax) -> Props:
    """Dispersion tensor, sigma_v, angular momentum and shape within R_Vmax
    (reference RVmax_* fields, substructureproperties.cxx:430-520)."""
    pfof, pos, vel, mass = group_sorted(pfof, pos, vel, mass)
    A, B = _passes(pos, vel, mass, pfof, num_groups)
    return _run_blocks([_rvmax(pos, pfof, A, refpos=refpos, refvel=refvel,
                               rmax=rmax)], (A, B))[0]


def _rvmax(pos, pfof, A: _Pass, *, refpos, refvel, rmax):
    dtype = pos.dtype
    sel = (pfof > 0) & (seg.sq3(pos - refpos[pfof]) < rmax[pfof] ** 2)
    i = A.add(sel, c=refpos, u=refvel)
    yield
    yield
    s = A.sums[i][0]
    msum = torch.clamp_min(s[:, MK.M], 1e-30)[:, None, None]
    vd = (_sym(s[:, MK.MVV:MK.MVV + 6]) / msum).to(dtype)
    q, s_, evecs = _eig_shape((_sym(s[:, MK.MXX:MK.MXX + 6]) /
                               msum).to(dtype))
    return {
        "RVmax_veldisp": vd,
        "RVmax_sigV": _sigma(vd),
        "RVmax_L": _vec(s, MK.ML).to(dtype),
        "RVmax_q": q,
        "RVmax_s": s_,
        "RVmax_eigvec": evecs,
        "RVmax_npart": s[:, MK.COUNT].long(),
    }


LOWRESTYPES = (2, 3)  # zoom low-res DM ("interloper", reference HIGHRES)
PERTYPE_TYPES = (("gas", C.GASTYPE), ("star", C.STARTYPE), ("bh", C.BHTYPE))
# per-particle hydro fields the per-type blocks read where a snapshot has them
HYDRO_FIELDS = ("u", "sfr", "zmet", "tage", "bhmdot")


def compute_pertype_properties(pos, vel, mass, ptype, pfof, num_groups: int,
                               *, refpos, refvel, **kw) -> Props:
    """Per-particle-type bulk properties of groups 1..num_groups (gas,
    star and black-hole sub-properties; reference GetProperties' GASON /
    STARON / BHON blocks, substructureproperties.cxx:266+, fields
    allvars.h:1322-1528).  Keywords as ``_pertype``."""
    ex = [kw.pop(k, None) for k in HYDRO_FIELDS]
    pfof, pos, vel, mass, ptype, *ex = group_sorted(pfof, pos, vel, mass,
                                                    ptype, *ex)
    hydro = dict(zip(HYDRO_FIELDS, ex))
    A, B = _passes(pos, vel, mass, pfof, num_groups, **hydro)
    return _run_blocks([_pertype(pos, mass, ptype, pfof, num_groups, A, B,
                                 refpos=refpos, refvel=refvel, **hydro,
                                 **kw)], (A, B))[0]


def _pertype(pos, mass, ptype, pfof, num_groups: int, A: _Pass, B: _Pass,
             *, refpos, refvel, types=PERTYPE_TYPES, u=None, sfr=None,
             zmet=None, tage=None, bhmdot=None, rvmax=None, r200c=None,
             r200m=None, r500c=None, rBN98=None, r30: float = 0.0,
             r50: float = 0.0, zoomlowmassdm: float = 0.0,
             full: bool = True):
    """Per-type sums of group-sorted particles, each type (and the gas's
    star-forming / non-star-forming split, SFR > 0) one selection of pass A
    about the reference centre and velocity and of pass B about its own
    mean velocity and angular momentum; the half-mass radii share one
    (group, radius) sort.  ``full``: also the velocity dispersion tensor,
    shape (q, s, eigenvectors), Krot, the mass within twice the half-mass
    radius, the fixed-aperture masses (``r30`` / ``r50`` = 30 / 50 kpc in
    internal units) and the SO-scoped masses and angular momenta
    (M_200crit_gas, L_200mean_star, ...) for the SO radii given, each scope
    a selection of pass A.  The zoom low-resolution "interloper" block
    comes with ``full``."""
    n = pos.shape[0]
    ng1 = num_groups + 1
    dtype = pos.dtype
    r2 = seg.sq3(pos - refpos[pfof])
    perm = seg.lexsort2(r2, pfof)
    g_s = pfof[perm]
    offsets = seg.group_offsets(g_s, num_groups)
    r_s = torch.sqrt(torch.clamp_min(r2[perm], 1e-30))
    m_s = mass[perm]
    in_s = g_s > 0
    tagged = pfof > 0

    # the type blocks in the reference's order: (name, selection, gas
    # fields, age)
    blocks = []
    for tname, tval in types:
        sel = (ptype == tval) & tagged
        blocks.append((tname, sel, tname == "gas", tname == "star"))
        if tname == "gas" and sfr is not None and full:
            # star-forming / non-star-forming split (reference gas_sf /
            # gas_nsf blocks, allvars.h:1385-1460)
            blocks.append(("gas_sf", sel & (sfr > 0), True, False))
            blocks.append(("gas_nsf", sel & (sfr <= 0), True, False))
    tsel = torch.stack([b[1] for b in blocks], 1)
    nt = tsel.shape[1]
    it = A.add(tsel, c=refpos, u=refvel)

    # radius scopes: RVmax, fixed apertures, SO radii; each (key format,
    # with L, squared radius a group) -- r2 < R^2 as the reference's
    # float32 compare
    so = [(name, rad) for name, rad in (
        ("200crit", r200c), ("200mean", r200m), ("500c", r500c),
        ("BN98", rBN98)) if rad is not None]
    scopes, r2cut = [], []
    if full:
        if rvmax is not None:
            scopes.append(("M_{t}_rvmax", False))
            r2cut.append(rvmax ** 2)
        for key, rr in (("M_{t}_30kpc", r30), ("M_{t}_50kpc", r50)):
            if rr > 0.0:
                scopes.append((key, False))
                r2cut.append(torch.full((ng1,), rr * rr, dtype=dtype,
                                        device=pos.device))
        scopes += [(f"M_{sname}_{{t}}", True) for sname, _ in so]
        r2cut += [rad ** 2 for _, rad in so]
    ns = len(scopes)
    if ns:
        inside = r2[:, None] < torch.stack(r2cut, 1)[pfof]
        isc = A.add((tsel[:, :, None] & inside[:, None, :]).reshape(n, -1),
                    c=refpos, u=refvel)
    if full:
        # zoom low-resolution "interloper" block; DM heavier than
        # zoomlowmassdm also counts (substructureproperties.cxx:931)
        sel_lr = ((ptype == LOWRESTYPES[0]) | (ptype == LOWRESTYPES[1])) & \
            tagged
        if zoomlowmassdm > 0.0:
            sel_lr = sel_lr | ((ptype == C.DARKTYPE) &
                               (mass > zoomlowmassdm) & tagged)
        lr = [sel_lr[:, None]]
        if so:
            lr.append(sel_lr[:, None] & inside[:, ns - len(so):])
        ilr = A.add(torch.cat(lr, 1), c=refpos, u=refvel)
    yield

    st = A.sums[it]
    msum = st[:, :, MK.M]
    cmv = _per(st, MK.MV, msum)
    L = _vec(st, MK.ML)
    L32 = L.to(dtype)
    jh = L32 / torch.clamp_min(torch.sqrt(seg.sq3(L32)), 1e-30)[..., None] \
        if full else None
    ib = B.add(tsel, c=refpos, u=cmv, a=jh)
    yield

    sb = B.sums[ib]
    out: Props = {}
    # every type's quantities at once, (nt, ng1, ...); a type's are views
    msafe = torch.clamp_min(msum, 1e-30)
    m3 = msafe[..., None, None]
    n_t = st[:, :, MK.COUNT].long()
    M_t = msum.to(dtype)
    cm_t = _per(st, MK.MX, msum).to(dtype)
    cmv_t = cmv.to(dtype)
    sigV_t = torch.sqrt(sb[:, :, MK.MV2] / msafe / 3.0).to(dtype)
    if full:
        veldisp_t = (_sym(sb[:, :, MK.MVV:MK.MVV + 6]) / m3).to(dtype)
        iten_t = (_sym(st[:, :, MK.MXX:MK.MXX + 6]) / m3).to(dtype)
        krot_t = (sb[:, :, MK.KROT] / torch.clamp_min(
            0.5 * sb[:, :, MK.MV2], 1e-30)).to(dtype)
        if ns:
            ssc = A.sums[isc].view(nt, ns, ng1, -1)
            M_sc = ssc[..., MK.M].to(dtype)
            L_sc = _vec(ssc, MK.ML).to(dtype)
    fields = {}
    for name in A.names:
        if name != "W":
            c = A.field(name)
            fields[name] = (st[:, :, c].to(dtype),
                            (st[:, :, c + 1] / msafe).to(dtype))

    for t, (tname, sel, with_temp_sfr, with_age) in enumerate(blocks):
        out[f"n_{tname}"] = n_t[t]
        out[f"M_{tname}"] = M_t[t]
        out[f"cm_{tname}"] = cm_t[t]
        out[f"cmvel_{tname}"] = cmv_t[t]
        out[f"sigV_{tname}"] = sigV_t[t]
        out[f"L_{tname}"] = L32[t]
        # half-mass radius of the type (radius-sorted masked cumsum)
        Mcum_t64 = seg.segment_cumsum(
            torch.where(sel[perm], m_s, 0.0).double(), g_s, offsets)
        Mcum_t = Mcum_t64.to(m_s.dtype)
        khalf = _first_crossing(_above_half(Mcum_t64, g_s, in_s, ng1), g_s,
                                ng1)
        rhalf = torch.where(khalf < n, r_s[torch.clamp_max(khalf, n - 1)],
                            0.0)
        out[f"R_HalfMass_{tname}"] = rhalf
        if full:
            k2h = _first_crossing((r_s > 2.0 * rhalf[g_s]) & in_s, g_s, ng1)
            k2c = torch.clamp(k2h - 1, 0, n - 1)
            # a group without members of the type reports 0 (its crossing
            # would land on the group's first slot and read the previous
            # group's cumulative mass)
            out[f"MassTwiceRhalfmass_{tname}"] = torch.where(
                M_t[t] > 0, torch.where(k2h < n, Mcum_t[k2c], M_t[t]), 0.0)
            out[f"veldisp_{tname}"] = veldisp_t[t]
            # shape from the mass-weighted inertia tensor about the centre
            evals, evecs = torch.linalg.eigh(iten_t[t])
            lam = torch.clamp_min(evals[:, 2], 1e-30)
            out[f"q_{tname}"] = torch.sqrt(
                torch.clamp_min(evals[:, 1], 0.0) / lam)
            out[f"s_{tname}"] = torch.sqrt(
                torch.clamp_min(evals[:, 0], 0.0) / lam)
            out[f"eigvec_{tname}"] = evecs
            # rotational share of the kinetic energy about the type's L
            out[f"Krot_{tname}"] = krot_t[t]
            # radius-scoped masses: RVmax, fixed apertures, SO radii
            for j, (key, with_l) in enumerate(scopes):
                out[key.format(t=tname)] = M_sc[t, j]
                if with_l:
                    out["L" + key.format(t=tname)[1:]] = L_sc[t, j]
        if with_temp_sfr:
            if u is not None:
                # reference substructureproperties.cxx:527-528, 592:
                # Temp_* is the unweighted sum of internal energies,
                # Temp_mean_* the mass-weighted mean; no unit conversion
                out[f"Temp_{tname}"] = fields["u"][0][t]
                out[f"Temp_mean_{tname}"] = fields["u"][1][t]
            if sfr is not None and not tname.endswith("nsf"):
                out[f"SFR_{tname}"] = fields["sfr"][0][t]
                out[f"SFR_mean_{tname}"] = (st[t, :, A.field("sfr")] /
                                            msafe[t]).to(dtype)
            if zmet is not None:
                out[f"Zmet_{tname}"] = fields["zmet"][1][t]
        if with_age and tage is not None:
            out["t_mean_star"] = fields["tage"][1][t]
        if tname == "star" and zmet is not None:
            out["Zmet_star"] = fields["zmet"][1][t]
        if tname == "bh":
            mmax = seg.segment_max(torch.where(sel, mass, 0.0), pfof, ng1)
            out["M_bh_mostmassive"] = mmax
            if bhmdot is not None:
                out["acc_bh"] = fields["bhmdot"][0][t]
                # accretion rate of the group's most massive black hole
                ismax = sel & (mass >= mmax[pfof]) & (mmax[pfof] > 0)
                out["acc_bh_mostmassive"] = seg.segment_max(
                    torch.where(ismax, bhmdot, 0.0), pfof, ng1)
    if full:
        slr = A.sums[ilr]
        out["n_interloper"] = slr[0, :, MK.COUNT].long()
        out["M_interloper"] = slr[0, :, MK.M].to(dtype)
        for j, (sname, _) in enumerate(so):
            out[f"M_{sname}_interloper"] = slr[1 + j, :, MK.M].to(dtype)
    return _zero_row0(out, ng1)


def compute_energies(vel, mass, pfof, W, num_groups: int, gcmvel,
                     Eratio: float) -> Props:
    """Bound mass fraction and potential / kinetic energy totals per group
    (reference GetBindingEnergy, substructureproperties.cxx:3884)."""
    pfof, vel, mass, W = group_sorted(pfof, vel, mass, W)
    A, B = _passes(torch.zeros_like(vel), vel, mass, pfof, num_groups, W=W)
    return _run_blocks([_energies(vel, mass, pfof, W, gcmvel, Eratio, A)],
                       (A, B))[0]


def _energies(vel, mass, pfof, W, gcmvel, Eratio: float, A: _Pass):
    dtype = vel.dtype
    T = 0.5 * mass * seg.sq3(vel - gcmvel[pfof])
    E = _f(Eratio, T) * T + W
    ing = pfof > 0
    i = A.add(torch.stack([ing, ing & (E < 0)], 1), u=gcmvel)
    yield
    yield
    s = A.sums[i]
    mtot = torch.clamp_min(s[0, :, MK.M], 1e-30)
    return {
        "Efrac": (s[1, :, MK.M] / mtot).to(dtype),
        "Epot": (0.5 * s[0, :, A.field("W")]).to(dtype),
        "Ekin_unbind": (0.5 * s[0, :, MK.MV2]).to(dtype),
    }


def property_bundle(opt: C.Options, pos, vel, mass, pfof, num_groups: int,
                    *, W=None, ptype=None, boxsize=None,
                    pertype: bool = False, u=None, sfr=None, zmet=None,
                    tage=None, bhmdot=None) -> Props:
    """The property stage as the reference sequences it inside
    GetProperties (substructureproperties.cxx:266+): reference-frame choice
    (``Reference_frame_for_properties``: CM, most bound particle or
    potential minimum, frame selection :327-340), core properties, the
    per-type blocks (``pertype``, with the hydro fields ``u``, ``sfr``,
    ``zmet``, ``tage``, ``bhmdot`` where the snapshot has them), apertures
    and profiles, the RVmax block and binding energies; the blocks after
    the core share passes A and B."""
    ptype = None if ptype is None else torch.as_tensor(ptype,
                                                       device=pos.device)
    pfof, pos, vel, mass, W, ptype, u, sfr, zmet, tage, bhmdot = \
        group_sorted(pfof, pos, vel, mass, W, ptype, u, sfr, zmet, tage,
                     bhmdot)
    refpos = refvel = None
    if opt.iPropertyReferencePosition != C.PROPREFCM and W is not None:
        if opt.iPropertyReferencePosition == C.PROPREFMINPOT:
            key = W
        else:       # PROPREFMBP
            s = _sums(_rows(pos, vel, mass),
                      seg.group_offsets(pfof, num_groups), pfof > 0)
            vmean = _per(s, MK.MV, s[:, MK.M]).to(vel.dtype)
            key = 0.5 * mass * seg.sq3(vel - vmean[pfof]) + W
        key = torch.where(pfof > 0, key, math.inf)
        if opt.ParticleTypeForRefenceFrame != -1 and ptype is not None:
            key = torch.where(ptype == opt.ParticleTypeForRefenceFrame, key,
                              math.inf)
        ridx = torch.clamp(seg.segment_argmin(key, pfof, num_groups + 1), 0,
                           pos.shape[0] - 1)
        refpos, refvel = pos[ridx], vel[ridx]

    pr = _properties(
        pos, vel, mass, pfof, num_groups,
        G=opt.G, boxsize=boxsize, rhocrit=opt.rhocrit, rhobg=opt.rhobg,
        virlevel=opt.virlevel if opt.virlevel > 0 else 200.0,
        virBN98=opt.virBN98,
        so_thresholds=tuple(opt.SOthresholds_values_crit),
        min_size=opt.MinSize, iIterateCM=bool(opt.iIterateCM),
        cmfrac=opt.pinfo.cmfrac, cmadjustfac=opt.pinfo.cmadjustfac,
        refpos=refpos)
    # centre of every radius-dependent stage below (the reference
    # re-references all positions to cmref up front, :320-340)
    ref_c = refpos if refpos is not None else pr["gcm"]
    gcmvel = pr["gcmvel"]
    pertype = pertype and ptype is not None
    hydro = dict(u=u, sfr=sfr, zmet=zmet, tage=tage, bhmdot=bhmdot) \
        if pertype else {}
    blocks = []
    A = B = None
    if pertype or opt.iaperturecalc or opt.iprofilecalc or \
            opt.iextrahalooutput or W is not None:
        A, B = _passes(pos, vel, mass, pfof, num_groups, **hydro, W=W)
    if pertype:
        to_int = 1.0 / opt.lengthtokpc if opt.lengthtokpc > 0 else 0.0
        blocks.append(_pertype(
            pos, mass, ptype, pfof, num_groups, A, B, refpos=ref_c,
            refvel=gcmvel, **hydro, rvmax=pr["gRmaxvel"], r200c=pr["gR200c"],
            r200m=pr["gR200m"], r500c=pr["gR500c"], rBN98=pr["gRBN98"],
            r30=30.0 * to_int, r50=50.0 * to_int,
            zoomlowmassdm=float(opt.zoomlowmassdm)))
    if opt.iaperturecalc or opt.iprofilecalc:
        to_int = 1.0 / opt.lengthtokpc if opt.lengthtokpc > 0 else 1.0
        aps = tuple(a * to_int for a in opt.aperture_values_kpc) \
            if opt.iaperturecalc else ()
        aps_proj = tuple(a * to_int for a in opt.aperture_proj_values_kpc) \
            if opt.iaperturecalc else ()
        edges = tuple(opt.profile_bin_edges) if opt.iprofilecalc else ()
        blocks.append(_apertures(
            pos, vel, mass, pfof, num_groups, A, B, refpos=ref_c,
            refvel=gcmvel, apertures=aps, apertures_proj=aps_proj,
            profile_edges=edges, iprofilenorm=opt.iprofilenorm,
            R200c=pr["gR200c"]))
    if opt.iextrahalooutput:
        blocks.append(_rvmax(pos, pfof, A, refpos=ref_c, refvel=gcmvel,
                             rmax=pr["gRmaxvel"]))
    if W is not None:
        blocks.append(_energies(vel, mass, pfof, W, gcmvel,
                                opt.uinfo.Eratio, A))
    for res in _run_blocks(blocks, (A, B) if blocks else ()):
        pr.update(res)
    return pr
