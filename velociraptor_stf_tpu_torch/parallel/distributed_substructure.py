"""The substructure recursion's per-structure searches over a mesh (port
of velociraptor_stf_tpu/parallel/distributed_substructure.py), the
analog of the reference's SearchSubSub with whole halos per rank
(search.cxx:2480-2946): structures are independent, so sharding is data
placement.

The structures of a level are dealt whole to the shards by serpentine
LPT on their sizes (``grouppack.assign_groups_lpt``); each shard runs
``search_subset`` and the merger-core search
(``models/substructure.py::_cores_and_merges``) on its own structures,
and their candidate ids come back to the home device.  The splice keeps
the single-device order, so ids and hierarchy come out the same.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..utils import config as C
from . import collectives as col
from .grouppack import assign_groups_lpt
from .mesh import Mesh

_ARRAYS = ("ppos", "pvel", "pmass", "ell", "valid")


@col.staged("substructure")
def distributed_structure_search(opt: C.Options, prep: List[dict],
                                 level: int, cores_on: bool,
                                 mesh: Mesh) -> None:
    """Fill ``e["sub"]`` / ``e["ng_sub"]`` of every prepared structure of
    a level (``search_sub_sub``'s entries), each searched on the shard it
    is dealt to."""
    from ..models import substructure as S

    if not prep:
        return
    shard = assign_groups_lpt(np.array([0] + [e["nsub"] for e in prep]),
                              mesh.size)[1:]
    for e, s in zip(prep, shard):
        d = mesh.devices[s]
        local = dict(e)
        local.update({k: col.move(e[k], d) for k in _ARRAYS})
        col.count_reshard("substructure", [local[k] for k in _ARRAYS])
        nsub = e["nsub"]
        local["sub"], local["ng_sub"] = S.search_subset(
            opt, local["ppos"][:nsub], local["pvel"][:nsub],
            local["pmass"][:nsub], local["ell"][:nsub],
            bounds=e["bounds"], npad=e["npad"])
        S._cores_and_merges(opt, local, level, cores_on)
        e["sub"] = col.move(local["sub"], mesh.home)
        e["ng_sub"] = local["ng_sub"]
        col.count_reshard("substructure", [e["sub"]])
