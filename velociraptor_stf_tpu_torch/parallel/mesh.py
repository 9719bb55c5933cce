"""A mesh of shards (port of velociraptor_stf_tpu/parallel/mesh.py).

The JAX package shards its particle arrays over a 1-D ``jax.sharding.Mesh``
and runs per-device bodies under ``jax.shard_map``, from one controller.
The port keeps that model in one process: a ``Mesh`` is an ordered tuple of
``torch.device``s, one per shard; a sharded array is a list of tensors,
shard ``s`` on ``mesh.devices[s]``; a per-device body is a plain function
that a loop calls once per shard; every movement between shards goes
through ``parallel/collectives.py``.

Shards may share a device: ``Mesh((torch.device("cuda:0"),) * 4)`` puts
four shards on one card, which drives every exchange of the mesh path on a
one-card machine.  Whole-array tensors (the caller's inputs and the
pipeline's per-particle outputs) live on ``mesh.home``, the first shard's
device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch


@dataclass(frozen=True)
class Mesh:
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one shard")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """The device of whole-array tensors (the first shard's)."""
        return self.devices[0]


def make_mesh(n_devices: Optional[int] = None,
              device: Union[str, torch.device] = "cuda") -> Mesh:
    """The first ``n_devices`` visible cards (all by default) for
    ``device="cuda"``; ``n_devices`` CPU shards (default 1) for
    ``device="cpu"``, the tests' stand-in for virtual host devices."""
    kind = torch.device(device).type
    if kind == "cpu":
        return Mesh((torch.device("cpu"),) * (n_devices or 1))
    if kind != "cuda":
        raise ValueError(f"no mesh over {kind} devices")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if n < 1 or n > count:
        raise ValueError(f"asked for {n} cards, {count} visible")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
