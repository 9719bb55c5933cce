"""Counters of the port's decisions and traffic.

Once the port's copy of ``velociraptor_stf_tpu/utils/telemetry.py``, kept so
that the port imports nothing of the JAX package.

A path that quietly hands work elsewhere, or traffic that grows with the
input, can cost a run its speed with nothing in the logs; each such event
increments a named counter here, read with ``snapshot()``.  The counters
are process-global; while spans record (``utils/timing.py``) each count
also lands on the innermost open span, so a profiled run reads them per
catalog and per stage.  The keys, each with its reader:

  subsub_level<L>_structures / _candidates / _found
      structures searched at recursion level L, candidates before the
      level's unbind, substructures found (``models/substructure.py``;
      ``chip_smoke.py`` phase 9, tests/test_torch_subsub.py,
      test_torch_subcli.py, test_torch_spans.py)
  subsub_cores_promoted
      merger cores promoted to substructures (``chip_smoke.py`` phase 9)
  subset_batched_particles
      padded particles of the structures whose subset search ran
      (tests/test_torch_subset_batch.py, test_torch_subcli.py,
      ``chip_smoke.py`` phase 9)
  subset_batches / subset_batch_candidates / subset_batch_pairs
      the batched subset search's batches, candidate slots and pairs
      tested (tests/test_torch_subset_batch.py, ``chip_smoke.py`` phase 9)
  baryon_pairs
      (baryon, tagged DM) candidate pairs of the association
      (``models/baryons.py``, ``parallel/distributed_baryons.py``;
      tests/test_torch_baryons.py, ``chip_smoke.py`` phase 8)
  coll_bytes::<stage>::<kind> / coll_ops::<stage>::<kind>
      the mesh's moves between shards (``parallel/collectives.py``;
      tests/test_torch_mesh.py, test_torch_distributed.py,
      test_torch_collective_audit.py, ``chip_smoke.py`` phase 10)
  mesh_slab_load::<stage>::shard<s> / mesh_group_load::<stage>::shard<s>
  / mesh_candidates::<fof3d|fof6d>::shard<s>
      the shards' loads and the slab FOF's candidate pairs
      (``parallel/distributed_fof.py``, ``grouppack.py``;
      ``chip_smoke.py`` phase 10)
  <fof3d|fof6d>_outer_rounds
      the slab FOF's cross-slab rounds (tests/test_torch_distributed.py,
      ``chip_smoke.py`` phase 10)
  mesh_full_gathers / mesh_full_gathers::<what>
      whole-array fetches to the host (``utils/transfer.py``;
      tests/test_torch_collective_audit.py)
  transfer_staged_bytes / transfer_staged_chunks
      bytes and chunks of the bulk copies that crossed between host and
      card through ``utils/transfer.py``'s pinned staging ring, either way
      (on the ``to_device`` spans for the copies in)
  transfer_direct_bytes
      bytes of the bulk copies that took the direct ``.to(...)`` /
      ``.cpu()``: on the CPU, below the ring's threshold, of a dtype it
      does not take
  transfer_pinned_bytes
      the ring's page-locked bytes, counted once, when it is allocated
      (all four: tests/test_torch_transfer_staging.py)
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

from . import timing

_COUNTERS: Counter = Counter()


def count(key: str, n: int = 1) -> None:
    _COUNTERS[key] += int(n)
    timing.add_count(key, int(n))


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
