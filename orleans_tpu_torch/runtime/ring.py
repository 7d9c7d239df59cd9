"""Consistent-hash ring of silos (a copy of
``orleans_tpu/runtime/ring.py``).

Parity: reference ConsistentRingProvider (one point per silo,
reference: src/OrleansRuntime/ConsistentRing/ConsistentRingProvider.cs:39,
GetPrimaryTargetSilo :74) and VirtualBucketsRingProvider (N virtual buckets
per silo, reference: VirtualBucketsRingProvider.cs:38,:264), with
range-change notifications consumed by reminders/streams
(reference: IRingRangeListener).

``owners_of_hashes`` is the batched lookup behind the cross-silo vector
data plane; ``device_shard_of_keys`` is the device-granularity twin of the
owner lookup (``tensor/arena.shard_of_keys``).
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Optional

from orleans_tpu_torch.hashing import jenkins_hash
from orleans_tpu_torch.ids import GrainId, SiloAddress

RANGE_SIZE = 1 << 32


def device_shard_of_keys(keys, n_shards: int):
    """The ring's device-granularity owner lookup: which shard block
    holds a grain key's state row (the one canonical hash,
    ``tensor/arena.shard_of_keys``)."""
    from orleans_tpu_torch.tensor.arena import shard_of_keys
    return shard_of_keys(keys, n_shards)


RingChangeListener = Callable[[List[SiloAddress], List[SiloAddress]], None]


class VirtualBucketsRing:
    """Ring with N virtual buckets per silo (the reference's recommended
    provider; reference: VirtualBucketsRingProvider.cs:38).

    Thread-safety is unnecessary (single event loop per silo); updates come
    from membership notifications.
    """

    def __init__(self, my_address: SiloAddress, buckets_per_silo: int = 30):
        self.my_address = my_address
        self.buckets_per_silo = buckets_per_silo
        self._points: List[int] = []          # sorted bucket hashes
        self._owners: Dict[int, SiloAddress] = {}
        self._members: List[SiloAddress] = []
        self._listeners: List[RingChangeListener] = []
        # bumped on every topology change; consumers caching derived
        # lookup tables (the vector router's owner arrays) key on it
        self.version = 0
        self._owner_table = None
        self.add_silo(my_address)

    # -- membership-driven updates -----------------------------------------

    def _bucket_hashes(self, silo: SiloAddress) -> List[int]:
        return [jenkins_hash(f"{silo.host}:{silo.port}@{silo.generation}#{i}"
                             .encode("utf-8"))
                for i in range(self.buckets_per_silo)]

    def add_silo(self, silo: SiloAddress) -> None:
        if silo in self._members:
            return
        self._members.append(silo)
        for h in self._bucket_hashes(silo):
            if h in self._owners:
                continue  # vanishing-probability collision: first owner wins
            bisect.insort(self._points, h)
            self._owners[h] = silo
        self._notify()

    def remove_silo(self, silo: SiloAddress) -> None:
        if silo not in self._members:
            return
        self._members.remove(silo)
        for h in self._bucket_hashes(silo):
            if self._owners.get(h) == silo:
                del self._owners[h]
                idx = bisect.bisect_left(self._points, h)
                if idx < len(self._points) and self._points[idx] == h:
                    self._points.pop(idx)
        self._notify()

    @property
    def members(self) -> List[SiloAddress]:
        return list(self._members)

    def subscribe(self, listener: RingChangeListener) -> None:
        self._listeners.append(listener)

    def _notify(self) -> None:
        self.version += 1
        self._owner_table = None
        members = self.members
        for listener in self._listeners:
            listener(members, members)

    # -- lookups (reference: ConsistentRingProvider.GetPrimaryTargetSilo :74)

    def owner_of_hash(self, point: int) -> Optional[SiloAddress]:
        if not self._points:
            return None
        # owner = first bucket clockwise from the point
        idx = bisect.bisect_left(self._points, point % RANGE_SIZE)
        if idx == len(self._points):
            idx = 0
        return self._owners[self._points[idx]]

    def calculate_target_silo(self, grain_id: GrainId) -> Optional[SiloAddress]:
        """(reference: LocalGrainDirectory.CalculateTargetSilo :439)"""
        return self.owner_of_hash(grain_id.ring_hash())

    def owners_of_hashes(self, points):
        """Vectorized ``owner_of_hash`` for a uint32 array of ring points.

        Returns ``(owner_idx int32[n], members)`` where ``owner_idx[i]``
        indexes into ``members`` (-1 only on an empty ring).  This is the
        batched ownership lookup behind the cross-silo vector data plane:
        one searchsorted over the bucket points instead of a bisect per
        message (same semantics as ``owner_of_hash``'s bisect_left)."""
        import numpy as np
        table = self._owner_table
        if table is None:
            if not self._points:
                table = (None, None, [])
            else:
                members = self.members
                midx = {s: i for i, s in enumerate(members)}
                pts = np.asarray(self._points, dtype=np.int64)
                own = np.asarray([midx[self._owners[p]]
                                  for p in self._points], dtype=np.int32)
                table = (pts, own, members)
            self._owner_table = table
        pts, own, members = table
        points = np.asarray(points)
        if pts is None:
            return np.full(len(points), -1, dtype=np.int32), members
        idx = np.searchsorted(pts, points.astype(np.int64))
        idx[idx == len(pts)] = 0  # wrap: first bucket clockwise
        return own[idx], members
