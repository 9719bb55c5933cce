"""Faults planted in the program, to show that the comparison catches
them: a stage that returns its input unchanged (the recursion, every
unbind, the baryon association), half of the input left out, an answer
altered where it is produced, in a cell on several cards the exchange
between the cards left out, and a configuration's own mechanism swapped
for another's (the adaptive 6D scale, the FOF-particle SO).

A patch fault replaces a function of the program through ``setattr``
(pytest's ``monkeypatch.setattr``, or the plain one for a process that
ends after its readings); a catalog fault wraps the catalog call.  The
benchmark's own runs never plant one: the CPU tests
(``tests/test_benchmark_control.py``) and ``readings.py --fault`` do.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch


def unchanged_substructure(set_attr) -> None:
    """The recursion returns the field halos as it got them, with a flat
    hierarchy."""
    from velociraptor_stf_tpu_torch.models import substructure

    def flat(opt, pos, vel, mass, pfof, ng, **kw):
        return (pfof, ng, np.full(ng + 1, -1, np.int64),
                np.zeros(ng + 1, np.int64), np.zeros(ng + 1, np.int32))

    set_attr(substructure, "search_sub_sub", flat)


def unbind_skipped(set_attr) -> None:
    """Every unbind (the recursion's level-wide one and the baryons'
    combined one) keeps every member: it runs with a kinetic-to-potential
    ratio of 0, so no particle is unbound."""
    from velociraptor_stf_tpu_torch.models import unbind

    real = unbind.check_unbound_groups

    def keep_all(pos, vel, mass, pfof, num_groups, uinfo, *a, **kw):
        return real(pos, vel, mass, pfof, num_groups,
                    dataclasses.replace(uinfo, Eratio=0.0), *a, **kw)

    set_attr(unbind, "check_unbound_groups", keep_all)


def unchanged_baryons(set_attr) -> None:
    """The baryon association leaves every baryon ungrouped."""
    from velociraptor_stf_tpu_torch.models import baryons

    def none(opt, pos_dm, vel_dm, pfof_dm, pos_b, vel_b, **kw):
        return torch.zeros(pos_b.shape[0], dtype=torch.int32,
                           device=pos_b.device)

    set_attr(baryons, "search_baryons", none)


def exchange_left_out(set_attr) -> None:
    """Every exchange between a mesh's shards (``collectives.ppermute``:
    the slab search's boundary particles, the density's ghosts) delivers
    zeros of the payload's shape in place of the payload."""
    from velociraptor_stf_tpu_torch.parallel import collectives

    real = collectives.ppermute

    def zeros(mesh, xs, perm):
        return real(mesh, [torch.zeros_like(x) for x in xs], perm)

    set_attr(collectives, "ppermute", zeros)


def adaptive_scale_global(set_attr) -> None:
    """Under FOF6DADAPTIVE the 6D search links every 3D group with the
    largest group's velocity scale, as FOF6D does, not with its own."""
    from velociraptor_stf_tpu_torch.models import halos

    def largest_group(opt, pfof3, ng3):
        return (pfof3 == 1).long(), 2

    def one_scale(opt, sig2, pfof3):
        return torch.where(pfof3 > 0, sig2[1] * opt.ellhalo6dvfac ** 2, 1.0)

    set_attr(halos, "scale_groups", largest_group)
    set_attr(halos, "scales_per_particle", one_scale)


def so_all_particles(set_attr) -> None:
    """The field halos' inclusive SO of ``Inclusive_halo_masses`` 1 and 2
    (from their own FOF particles) is computed as mode 3's, from every
    particle around the centre."""
    from velociraptor_stf_tpu_torch.models import pipeline

    real = pipeline._so_stage

    def as_mode3(opt, *a, **kw):
        opt = copy.copy(opt)
        opt.iInclusiveHalo = 3
        return real(opt, *a, **kw)

    set_attr(pipeline, "_so_stage", as_mode3)


PATCHES = {f.__name__: f for f in (unchanged_substructure, unbind_skipped,
                                   unchanged_baryons, exchange_left_out,
                                   adaptive_scale_global, so_all_particles)}


def half_left_out(catalog):
    """Every other particle left out of the search; the catalog's ids
    spread back over the whole snapshot."""

    def run(opt, hs, device, mesh=None):
        half = copy.copy(hs)
        a = dict(hs.arrays)
        n = a["pos"].shape[0]
        keep = np.arange(0, n, 2)
        for k in ("pos", "vel", "mass", "ptype"):
            if a[k] is not None:
                a[k] = a[k][keep]
        if a["extras"]:
            a["extras"] = {k: v[keep] for k, v in a["extras"].items()}
        half.arrays = a
        res = catalog(opt, half, device, mesh)
        pfof = np.zeros(n, res.pfof.dtype)
        pfof[keep] = res.pfof
        res.pfof = pfof
        if res.pfof3d is not None:
            dm = np.ones(n, bool) if a["ptype"] is None else \
                hs.arrays["ptype"] == 1
            p3 = np.zeros(n, res.pfof3d.dtype)
            p3[keep[dm[keep]]] = res.pfof3d
            res.pfof3d = p3[dm]
        return res

    return run


def id_altered(catalog):
    """One member of the largest structure handed to the second."""

    def run(opt, hs, device, mesh=None):
        res = catalog(opt, hs, device, mesh)
        g = np.nonzero(res.pfof == 1)[0]
        res.pfof = res.pfof.copy()
        res.pfof[g[0]] = 2
        return res

    return run


def parent_altered(catalog):
    """The first substructure's parent set to none."""

    def run(opt, hs, device, mesh=None):
        res = catalog(opt, hs, device, mesh)
        res.parent = res.parent.copy()
        sub = np.nonzero(res.parent > 0)[0]
        res.parent[sub[0]] = 0
        return res

    return run


WRAPPERS = {f.__name__: f for f in (half_left_out, id_altered,
                                    parent_altered)}
