"""ShardMesh: n logical shard blocks of the arena, all on one device.

The port's stand-in for the ``jax.sharding.Mesh`` the JAX engine takes
(``TensorEngine(mesh=...)``).  A JAX mesh spans n devices and an arena's
columns split into n row blocks, one per device; here the n blocks live
in one arena on one card: block ``s`` is rows ``[s * shard_capacity,
(s + 1) * shard_capacity)`` of every column, a key's block is its stable
hash mod n (``arena.shard_of_keys``, with live-migration pins), and the
cross-shard exchange's ``all_to_all`` becomes an on-card write into each
receiving block's region of the output (K24, ``kernels/exchange.py``).

``devices`` holds one entry per block, as ``Mesh.devices`` does, so
``devices.size == n_shards``; every entry is the same ``torch.device``.
``spans_devices`` says whether the blocks lie on more than one device,
which is what engages the structured exchange under
``exchange_structured="auto"`` (tensor/exchange.py ``engaged``): never on
one card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from orleans_tpu_torch.device import resolve_device


class ShardMesh:
    """``n_shards`` shard blocks along ``axis``, all on ``device`` (None:
    the card)."""

    def __init__(self, n_shards: int, device: Optional[Any] = None,
                 axis: str = "grains") -> None:
        n = int(n_shards)
        if n < 1:
            raise ValueError(f"a mesh needs at least one shard block, "
                             f"got {n_shards}")
        self.device = resolve_device(device)
        self.devices = np.empty(n, dtype=object)
        self.devices[:] = [self.device] * n
        self.axis_names = (axis,)

    @property
    def n_shards(self) -> int:
        return int(self.devices.size)

    @property
    def axis(self) -> str:
        return self.axis_names[0]

    def spans_devices(self) -> bool:
        """Whether the blocks lie on more than one device."""
        return len({str(d) for d in self.devices}) > 1

    def __repr__(self) -> str:
        return (f"ShardMesh(n_shards={self.n_shards}, device="
                f"{self.device}, axis={self.axis!r})")


@dataclass(frozen=True)
class BlockSharding:
    """The port's ``NamedSharding(mesh, PartitionSpec(axis))``: the marker
    an arena carries when its rows split into the mesh's blocks (the
    engine's exchange test reads ``arena.sharding is not None``)."""

    mesh: ShardMesh
    axis: str
