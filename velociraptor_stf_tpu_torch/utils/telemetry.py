"""Fallback / de-batching counters.

The port's copy of ``velociraptor_stf_tpu/utils/telemetry.py``, kept so that
the port imports nothing of the JAX package.

Silent performance fallbacks (a batched path quietly handing a structure
to the sequential path, a Pallas kernel latching its XLA fallback) hide
pathological inputs: a run can lose its whole batching win with nothing
in the logs.  Every such decision increments a named counter here;
``snapshot()`` is reported by the bench in verbose mode and can be
asserted on in tests.

The port counts ``fof3d_sweeps`` and ``fof6d_sweeps``
(``ops/fof_sweep.py``) and ``baryon_pairs``, the (baryon, tagged DM)
candidate pairs of the association (``models/baryons.py``).  Its mesh
path (``parallel/``) counts ``coll_bytes::<stage>::<kind>`` and
``coll_ops::<stage>::<kind>`` (``collectives.py``), the shards' loads
``mesh_slab_load::<stage>::shard<s>`` and
``mesh_group_load::<stage>::shard<s>``, the slab FOF's candidate pairs
``mesh_candidates::<fof3d|fof6d>::shard<s>`` and its cross-slab rounds
``<fof3d|fof6d>_outer_rounds``, and the catalog's host fetches
``mesh_full_gathers`` (``utils/transfer.py``).  Keys of the JAX package:
  subset_batched_structures / subset_batched_particles
      structures (and their padded particle counts) whose candidate
      search ran in a vmapped class batch
  subset_sequential_structures / subset_sequential_particles
      structures that fell to the per-structure sequential path
  subset_pair_cap_overflows
      lanes de-batched because the sparse cross-group pair table
      exceeded the per-structure cap (models/substructure.py)
  subset_dense_table_bailouts
      whole class batches skipped because the union grid exceeded the
      dense prefix-table budget
  pallas_fof_compile_fallbacks / pallas_gravity_compile_fallbacks
      Mosaic compile failures latched to the XLA paths
  pallas_fof_overflow_fallbacks
      Pallas field searches abandoned for the XLA edge pipeline because
      a ghost/subset capacity prepass overflowed
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

_COUNTERS: Counter = Counter()


def count(key: str, n: int = 1) -> None:
    _COUNTERS[key] += int(n)


def snapshot() -> Dict[str, int]:
    return dict(_COUNTERS)


def reset() -> None:
    _COUNTERS.clear()


def report(prefix: str = "FALLBACKS::") -> str:
    """One-line summary (printed by bench verbose mode)."""
    if not _COUNTERS:
        return f"{prefix} none"
    return prefix + " " + " ".join(
        f"{k}={v}" for k, v in sorted(_COUNTERS.items()))
