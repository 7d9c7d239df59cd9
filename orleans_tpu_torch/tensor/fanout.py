"""DeviceFanout: ragged one-to-many message expansion on the device.

The port of ``orleans_tpu/tensor/fanout.py``.  The reference's fan-out —
one grain holding a variable-size subscriber set and forwarding each
message to every subscriber (reference: Samples/Chirper/ChirperGrains/
ChirperAccount.cs:129-156 PublishMessage → Followers loop;
ObserverSubscriptionManager.Notify) — becomes one expansion of a whole
batch of published messages through a CSR edge table on the device (K11,
``kernels/fanout.py``): per output slot, the subscriber key and the source
lane whose payload it carries.

Overflow contract (as in the JAX package): a round whose messages need
more slots than the expansion width loses nothing and raises nothing.
Source lanes whose whole slot range does not fit deliver no slot this
round and come back as a device-side ``dropped`` mask (``take_drop``);
the engine parks it and expands exactly those lanes again at its next
quiescence point, with their original ``inject_tick``.  The storage
budget (more EDGES than ``budget``) stays a hard error at rebuild.

Mutation (follow/unfollow/add_edges) is host-side control plane; the
device CSR is a mirror rebuilt on the first expansion after a change.
Each rebuild bumps ``version``: a fused window bakes the CSR tensors'
addresses and rebuilds itself when the version it was built against
moved (the JAX window keeps the graph it was traced with — ROADMAP queue
C).  A mutation first settles the auto-fusers of the engines the graph is
registered with: ticks they hold buffered for a window were published
before it, so they run now, on the graph they were published under.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from orleans_tpu_torch.kernels.fanout import fanout_expand
from orleans_tpu_torch.kernels.resolve import KEY_SENTINEL
from orleans_tpu_torch.tensor.engine import _gather_lanes, _map_tree
from orleans_tpu_torch.tensor.vector_grain import ones_mask

Csr = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _group_ranges(sorted_vals: np.ndarray
                  ) -> Iterator[Tuple[Any, int, int]]:
    """Yield (value, start, end) for each run of equal values."""
    if len(sorted_vals) == 0:
        return
    boundaries = np.flatnonzero(np.diff(sorted_vals)) + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [len(sorted_vals)]])
    for s, e in zip(starts.tolist(), ends.tolist()):
        yield sorted_vals[s], s, e


class FanoutOverflowError(RuntimeError):
    """More STORED edges than the configured budget (a rebuild-time config
    error).  Per-round expansion overflow parks lanes instead."""


class DeviceFanout:
    """A mutable src→{dst...} subscription graph with device expansion.

    ``budget`` caps the stored edge count; the expansion width is the live
    edge count rounded up to 256 (at most ``budget``).  The CSR is built
    on the device of the source keys of the first expansion (one copy per
    device)."""

    def __init__(self, budget: int = 1 << 20) -> None:
        self.budget = int(budget)
        self._adj: Dict[int, List[int]] = {}
        self.edge_count = 0
        self._dirty = True
        self._csr_host: Optional[Tuple[np.ndarray, ...]] = None
        self._csr: Dict[torch.device, Csr] = {}
        # bumped by every rebuild of the CSR
        self.version = 0
        # the latest expand()'s (n_dropped, src_dropped), popped by
        # take_drop(); un-taken drops wait for overflow_check()
        self._pending_drops: List[Tuple[torch.Tensor, torch.Tensor]] = []
        # cumulative host-side stats, folded at drain points
        self.dropped_lanes = 0
        self.redeliveries = 0
        # the engines this graph is registered with (``register_fanout``)
        self._owners: List[weakref.ref] = []

    # -- control plane (host) ----------------------------------------------

    def bind_owner(self, engine) -> None:
        """Remember an engine that expands through this graph."""
        if all(ref() is not engine for ref in self._owners):
            self._owners.append(weakref.ref(engine))

    def _settle_owners(self) -> None:
        """Before a mutation: every owning engine's auto-fuser runs the
        ticks it holds (verifying or rolling back its chain), so they
        expand on the graph they were published under."""
        for ref in self._owners:
            engine = ref()
            if engine is not None and engine.autofuser.has_buffer():
                engine.autofuser.idle_flush()

    def follow(self, src: int, dst: int) -> None:
        """Subscribe ``dst`` to ``src``'s messages (reference:
        ChirperAccount.AddFollower)."""
        self._settle_owners()
        lst = self._adj.setdefault(int(src), [])
        if int(dst) not in lst:
            lst.append(int(dst))
            self.edge_count += 1
            self._dirty = True

    def unfollow(self, src: int, dst: int) -> None:
        self._settle_owners()
        lst = self._adj.get(int(src))
        if lst and int(dst) in lst:
            lst.remove(int(dst))
            self.edge_count -= 1
            self._dirty = True

    def followers_of(self, src: int) -> List[int]:
        return list(self._adj.get(int(src), ()))

    def add_edges(self, src_keys: np.ndarray, dst_keys: np.ndarray) -> None:
        """Bulk graph load: dedups against the batch and the existing edges
        with numpy, then extends the adjacency lists wholesale."""
        src = np.asarray(src_keys, dtype=np.int64)
        dst = np.asarray(dst_keys, dtype=np.int64)
        if len(src) == 0:
            return
        self._settle_owners()
        pairs = np.unique(np.stack([src, dst], axis=1), axis=0)
        added = 0
        for s, grp_start, grp_end in _group_ranges(pairs[:, 0]):
            lst = self._adj.setdefault(int(s), [])
            new = pairs[grp_start:grp_end, 1].tolist()
            if lst:
                existing = set(lst)
                new = [d for d in new if d not in existing]
            lst.extend(new)
            added += len(new)
        self.edge_count += added
        if added:
            self._dirty = True

    # -- device mirror -------------------------------------------------------

    def _rebuild(self) -> None:
        """The CSR on the host (sorted sources, offsets, destinations
        padded to the width with the sentinel); device copies follow on
        demand."""
        if self.edge_count > self.budget:
            raise FanoutOverflowError(
                f"{self.edge_count} edges exceed fanout budget {self.budget}")
        srcs = sorted(k for k, v in self._adj.items() if v)
        keys = np.asarray(srcs, dtype=np.int64)
        if (keys >= KEY_SENTINEL).any() or (keys < 0).any():
            raise OverflowError("fanout src keys must be in [0, 2**31-1)")
        width = min(self.budget,
                    max(256, -(-max(1, self.edge_count) // 256) * 256))
        dst = np.full(width, KEY_SENTINEL, dtype=np.int32)
        if not srcs:
            # a sentinel row, so the kernel never searches an empty array;
            # KEY_SENTINEL matches no valid source key
            keys32 = np.array([KEY_SENTINEL], np.int32)
            offsets = np.zeros(2, np.int32)
        else:
            degrees = np.fromiter((len(self._adj[s]) for s in srcs),
                                  dtype=np.int64, count=len(srcs))
            offsets = np.concatenate([[0], np.cumsum(degrees)]).astype(
                np.int32)
            dst[:offsets[-1]] = np.concatenate(
                [np.asarray(self._adj[s], dtype=np.int64) for s in srcs])
            keys32 = keys.astype(np.int32)
        self._csr_host = (keys32, offsets, dst)
        self._csr = {}
        self._dirty = False
        self.version += 1

    def csr(self, device: torch.device) -> Csr:
        """``(csr_keys, csr_offsets, csr_dst)`` on ``device``, rebuilt
        first when the graph changed."""
        if self._dirty:
            self._rebuild()
        out = self._csr.get(device)
        if out is None:
            out = self._csr[device] = tuple(
                torch.from_numpy(a).to(device) for a in self._csr_host)
        return out

    def current_version(self) -> int:
        """The version of the CSR an expansion would use now."""
        if self._dirty:
            self._rebuild()
        return self.version

    # -- data plane ----------------------------------------------------------

    def expand(self, src_keys: torch.Tensor, args: Any,
               mask: Optional[torch.Tensor] = None,
               n_dropped: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
        """(source keys int32[m], args [m, ...]) → (destination keys [W],
        args gathered per slot plus ``src_key``, valid mask [W]).

        Source lanes whose expansion does not fit this round's width
        deliver nothing; their count and mask wait for ``take_drop()``.
        Given ``n_dropped`` (a one-element int32 tensor), the count adds
        into it (a fused window's miss total)."""
        ck, co, cd = self.csr(src_keys.device)
        if mask is None:
            mask = ones_mask(src_keys.shape[0], src_keys.device)
        dst, src_index, out_valid, _total, src_dropped, count = \
            fanout_expand(ck, co, cd, src_keys, mask, n_dropped)
        self._pending_drops.append((count, src_dropped))
        gathered = _map_tree(lambda a: _gather_lanes(a, src_index), args)
        if isinstance(gathered, dict) and "src_key" not in gathered:
            gathered = {**gathered, "src_key": _gather_lanes(src_keys, src_index)}
        return dst, gathered, out_valid

    def take_drop(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(n_dropped device scalar, src_dropped device bool[m]) of the
        expand() that just ran."""
        return self._pending_drops.pop()

    def overflow_check(self) -> int:
        """Read the un-taken parked drop counts (direct expand() users),
        fold them into ``dropped_lanes`` and return their total."""
        drops, self._pending_drops = self._pending_drops, []
        total = sum(int(n) for n, _mask in drops)
        self.dropped_lanes += total
        return total
