"""Engine configuration: the ``TensorEngineConfig`` fields the port reads,
with the same names and defaults as ``orleans_tpu/config.py``."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class TensorEngineConfig:
    """Batched data-plane knobs (no reference analog)."""

    max_rounds_per_tick: int = 4          # intra-tick call-chain rounds
    # step handlers update the arena columns in place (the counterpart of
    # JAX's donated inputs); off = every step clones the columns first
    donate_state: bool = True
    # ring buffer of recent per-tick durations backing latency percentiles
    latency_window: int = 1024
    # padded host-batch buckets: a host batch pads to the smallest bucket
    # >= its size (padding lanes carry row -1 and are dropped)
    bucket_sizes: tuple = (256, 4096, 32768, 131072, 262144, 524288,
                           1 << 20)
    # max parked optimistic miss-checks before a forced (synchronizing)
    # drain — bounds device memory pinned by deferred delivery checks
    miss_check_cap: int = 16
