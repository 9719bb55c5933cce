"""The substructure recursion's per-structure searches over a mesh (port
of velociraptor_stf_tpu/parallel/distributed_substructure.py,
``distributed_subset_batch``), the analog of the reference's SearchSubSub
with whole halos per rank (search.cxx:2480-2946): structures are
independent, so sharding is data placement.

The structures of a level are dealt whole to the shards by serpentine
LPT on their sizes (``grouppack.assign_groups_lpt``); each shard runs one
subset search over all of its structures
(``models/substructure.py::search_subset_batch``), then one merger-core
search over them (``search_level_cores``), and the candidate ids come
back to the home device.  A structure's ids do not depend on the others
it is searched with, and the splice keeps the single-device order, so
ids and hierarchy come out the same.
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
    for s in range(mesh.size):
        mine = [e for e, t in zip(prep, shard) if t == s]
        if not mine:
            continue
        d = mesh.devices[s]
        local = []
        for e in mine:
            loc = dict(e)
            loc.update({k: col.move(e[k], d) for k in _ARRAYS})
            col.count_reshard("substructure", [loc[k] for k in _ARRAYS])
            local.append(loc)
        S.search_subset_batch(opt, local)
        S.search_level_cores(opt, local, level, cores_on)
        for e, loc in zip(mine, local):
            e["sub"] = col.move(loc["sub"], mesh.home)
            e["ng_sub"] = loc["ng_sub"]
            col.count_reshard("substructure", [e["sub"]])
