"""DeviceLatencyLedger: per-message latency histograms accumulated on
the device, in device-tick units.

The port of ``orleans_tpu/tensor/ledger.py``.  Each batch is stamped with
its injection tick (``PendingBatch.inject_tick``); the tick that applies
it records the tick delta into a per-(type, method) log2-bucket histogram.
Host-resolved batches have host-known counts and add into a host mirror
(no device work); device-routed batches count their applied lanes on the
card with K5 (``kernels/hist.py``), in place, so the histogram keeps one
address for its whole life — a fused window's CUDA graph adds into it
directly.  Only the small ``[MAX_SLOTS, buckets]`` int32 array crosses to
the host, at an explicit snapshot.

Bucket scheme: bucket 0 = delta 0 (completed in its inject tick), bucket
k = [2**(k-1), 2**k) ticks, the last bucket absorbs overflow.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from orleans_tpu_torch.kernels.hist import hist_count

#: fixed slot capacity: 64 distinct (type, method) pairs per engine, so
#: the device histogram's shape never changes for the engine's lifetime
MAX_SLOTS = 64


class SlotRegistry:
    """The (type, method) → slot map of the device accumulators keyed per
    method, bounded at MAX_SLOTS."""

    __slots__ = ("_slots", "_names")

    def __init__(self) -> None:
        self._slots: Dict[Tuple[str, str], int] = {}
        self._names: List[Tuple[str, str]] = []

    def __len__(self) -> int:
        return len(self._names)

    def items(self):
        return self._slots.items()

    def slot_for(self, type_name: str, method: str) -> int:
        key = (type_name, method)
        slot = self._slots.get(key)
        if slot is None:
            if len(self._names) >= MAX_SLOTS:
                raise RuntimeError(
                    f"slot registry capacity ({MAX_SLOTS} distinct "
                    "(type, method) pairs) exceeded")
            slot = len(self._names)
            self._slots[key] = slot
            self._names.append(key)
        return slot


def accumulate(hist: torch.Tensor, slot: int, deltas: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """One batched ledger update with a per-lane delta: bucket every lane
    (``ceil(log2(delta + 1))``, capped at the last bucket), count the
    valid lanes per bucket and add them into the slot's row, in place.
    No path of the engine calls it (batches share one delta, which K5
    counts); it is the plain version of a kernel still to be ported."""
    n_buckets = hist.shape[1]
    d = torch.clamp(deltas, min=0).to(torch.float32)
    b = torch.ceil(torch.log2(d + 1.0)).to(torch.int64)
    b = torch.clamp(b, max=n_buckets - 1)
    counts = torch.zeros(n_buckets, dtype=torch.int32, device=hist.device)
    counts.index_add_(0, b, valid.to(torch.int32))
    hist[slot] += counts
    return hist


def _bucket_of(delta: int, n_buckets: int) -> int:
    d = max(int(delta), 0)
    return 0 if d <= 0 else min(d.bit_length(), n_buckets - 1)


def bucket_bounds(base: float, n_buckets: int) -> List[Tuple[float, float]]:
    """[(lo, hi)) value range of every bucket (hi of the overflow bucket
    is inf)."""
    out = [(0.0, base)]
    for k in range(1, n_buckets):
        hi = base * (2.0 ** k) if k < n_buckets - 1 else float("inf")
        out.append((base * (2.0 ** (k - 1)), hi))
    return out


def percentile_from_counts(counts: Sequence[int], p: float,
                           base: float = 1.0) -> float:
    """The p-th percentile (p in [0, 100]) of log2 bucket counts, by
    linear interpolation inside the bucket holding the target rank."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return 0.0
    target = max(1.0, (p / 100.0) * total)
    bounds = bucket_bounds(base, len(counts))
    seen = 0
    for k, n in enumerate(counts):
        if n == 0:
            continue
        if seen + n >= target:
            lo, hi = bounds[k]
            if not np.isfinite(hi):
                hi = lo * 2.0  # overflow bucket: report its lower octave
            frac = (target - seen) / n
            return float(lo + frac * (hi - lo))
        seen += int(n)
    lo, _hi = bounds[-1]
    return float(lo)


class DeviceLatencyLedger:
    """Per-engine latency ledger: a host mirror for host-known batches and
    a device histogram for device-routed ones, merged by ``snapshot()``
    with ONE device→host copy (``d2h_fetches`` counts them)."""

    def __init__(self, device: torch.device, n_buckets: int = 16,
                 enabled: bool = True,
                 slots: Optional[SlotRegistry] = None) -> None:
        self.device = device
        self.enabled = enabled
        self.n_buckets = n_buckets
        self.slots = slots if slots is not None else SlotRegistry()
        self._hist: Optional[torch.Tensor] = None  # [MAX_SLOTS, n_buckets]
        self._host_hist = np.zeros((MAX_SLOTS, n_buckets), dtype=np.int64)
        self._dev_dirty = False      # device hist has unfetched updates
        self.d2h_fetches = 0         # completed device→host count reads
        self.records = 0             # record calls (host + device)
        self._last_fetch: Optional[np.ndarray] = None

    # -- configuration -------------------------------------------------------

    def configure(self, enabled: Optional[bool] = None,
                  n_buckets: Optional[int] = None) -> None:
        """Live reload.  Changing the bucket count resets the counts (the
        device array is replaced, so fused windows rebuild)."""
        if enabled is not None:
            self.enabled = enabled
        if n_buckets is not None and n_buckets != self.n_buckets:
            self.n_buckets = n_buckets
            self._hist = None
            self._host_hist = np.zeros((MAX_SLOTS, n_buckets),
                                       dtype=np.int64)
            self._dev_dirty = False
            self._last_fetch = None

    def snapshot_state(self) -> Tuple[Optional[torch.Tensor], np.ndarray]:
        """Rollback point for the auto-fuser's verification chain: a copy
        of the device counts (windows add into the live array in place)
        and of the host mirror."""
        hist = self._hist.clone() if self._hist is not None else None
        return hist, self._host_hist.copy()

    def restore_state(self, state: Tuple[Optional[torch.Tensor],
                                         np.ndarray]) -> None:
        """Undo every accumulation since ``snapshot_state`` — a rolled-back
        window's counts must vanish, or its unfused replay would count
        every message twice.  The device array is restored in place, so
        graphs holding its address stay valid."""
        hist, host = state
        if self._hist is not None:
            if hist is None:
                self._hist.zero_()
            else:
                self._hist.copy_(hist)
        self._host_hist = host
        self._last_fetch = None
        # the cached fetch is gone: the device counts are unfetched
        self._dev_dirty = self._hist is not None

    # -- slots ---------------------------------------------------------------

    def slot_for(self, type_name: str, method: str) -> int:
        return self.slots.slot_for(type_name, method)

    def _device_hist(self) -> torch.Tensor:
        if self._hist is None:
            self._hist = torch.zeros((MAX_SLOTS, self.n_buckets),
                                     dtype=torch.int32, device=self.device)
        return self._hist

    # -- accumulation --------------------------------------------------------

    def record_host(self, type_name: str, method: str, delta: int,
                    count: int) -> None:
        """Host-known batch: one numpy scalar add, no device work."""
        if not self.enabled or count <= 0 or delta < 0:
            return
        b = _bucket_of(delta, self.n_buckets)
        self._host_hist[self.slot_for(type_name, method), b] += count
        self.records += 1

    def record_rows(self, type_name: str, method: str, delta: int,
                    rows: torch.Tensor, base: torch.Tensor) -> None:
        """Device batch: count the applied lanes (base ∧ rows resolved)
        into hist[slot, bucket(delta)] with one K5 launch."""
        if not self.enabled or delta < 0:
            return
        slot = self.slot_for(type_name, method)
        hist_count(self._device_hist(), slot,
                   _bucket_of(delta, self.n_buckets), base, rows)
        self._dev_dirty = True
        self.records += 1

    # -- fused-window integration --------------------------------------------

    def device_hist_in(self) -> torch.Tensor:
        """The device histogram a fused window adds into."""
        return self._device_hist()

    def device_hist_out(self, hist: torch.Tensor) -> None:
        """A fused window added into ``hist`` (the live array)."""
        if hist is not self._hist:
            raise ValueError("fused window accumulated into a stale "
                             "ledger histogram")
        self._dev_dirty = True

    # -- snapshots -----------------------------------------------------------

    def fetch_counts(self) -> np.ndarray:
        """Total [slots, buckets] counts, host int64.  ONE device→host
        copy when the device side has unfetched updates, else free."""
        if self._dev_dirty and self._hist is not None:
            self._last_fetch = self._hist.cpu().numpy().astype(np.int64)
            self._dev_dirty = False
            self.d2h_fetches += 1
        dev = self._last_fetch if self._last_fetch is not None \
            else np.zeros_like(self._host_hist)
        return dev + self._host_hist

    def snapshot(self) -> Dict[str, Any]:
        """Per-(type, method) histogram with p50/p95/p99 in device ticks."""
        counts = self.fetch_counts()
        out: Dict[str, Any] = {}
        for (type_name, method), slot in self.slots.items():
            row = counts[slot]
            total = int(row.sum())
            if total == 0:
                continue
            out[f"{type_name}.{method}"] = {
                "counts": row.tolist(),
                "total": total,
                "p50_ticks": percentile_from_counts(row, 50),
                "p95_ticks": percentile_from_counts(row, 95),
                "p99_ticks": percentile_from_counts(row, 99),
            }
        return out

    def stats(self) -> Dict[str, Any]:
        """Cheap host-side ledger health (no transfer)."""
        return {"enabled": self.enabled, "n_buckets": self.n_buckets,
                "slots": len(self.slots), "records": self.records,
                "d2h_fetches": self.d2h_fetches}
