"""Configuration: the ``TensorEngineConfig`` and ``MetricsConfig`` fields
the engine reads and the ``SiloConfig`` sub-configs the clustered vector
data plane reads, with the same names and defaults as
``orleans_tpu/config.py`` (reference: GlobalConfiguration liveness
:149-194, directory :247-275)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TensorEngineConfig:
    """Batched data-plane knobs (no reference analog)."""

    # a silo builds its tensor engine only when enabled
    enabled: bool = True
    max_rounds_per_tick: int = 4          # intra-tick call-chain rounds
    # step handlers update the arena columns in place (the counterpart of
    # JAX's donated inputs); off = every step clones the columns first
    donate_state: bool = True
    # ring buffer of recent per-tick durations backing latency percentiles
    latency_window: int = 1024
    # activation collection (reference: ActivationCollector quantum + age
    # limit): rows idle > collection_idle_ticks are evicted (written back
    # when a store is attached) every collection_every_ticks.  0 disables
    # automatic sweeps (collect_idle() stays callable).
    collection_idle_ticks: int = 0
    collection_every_ticks: int = 64
    # incremental collection: a sweep's victims drain in chunks between
    # ticks, each slice capped at this host-pause budget (seconds); <= 0
    # runs the whole sweep in one slice (the synchronous baseline)
    collection_pause_budget_s: float = 0.005
    # victims written back per chunk (bounds one chunk's stall and the
    # device→host gather of one columnar write-back)
    collection_chunk_rows: int = 65536
    # freed/high-water ratio above which deactivation still repacks the
    # arena (rows move, generation bumps); <= 0 or > 1 disables it
    compact_fragmentation_threshold: float = 0.75
    # padded host-batch buckets: a host batch pads to the smallest bucket
    # >= its size (padding lanes carry row -1 and are dropped)
    bucket_sizes: tuple = (256, 4096, 32768, 131072, 262144, 524288,
                           1 << 20)
    # the shard-block axis of a ``ShardMesh`` (tensor/mesh.py)
    mesh_axis: str = "grains"
    # ---- the cross-shard exchange (tensor/exchange.py) ----
    # under a mesh of n shard blocks, device batches are bucketed by
    # destination block (K24) so each block's lanes land in its own
    # region of the output; off = delivery straight to the rows (the A/B
    # baseline).  A live toggle rebuilds fused windows (config_toggle).
    cross_shard_exchange: bool = True
    # when the structured exchange runs: "auto" engages it only when the
    # mesh's blocks span more than one device (on one card every block
    # shares one memory, so the exchange is identity plus a sampled
    # probe, K23); "always"/"never" force either side
    exchange_structured: str = "auto"
    # disengaged: every Nth eligible batch runs a measure-only probe
    exchange_probe_interval: int = 8
    # occupancy-sized buckets: caps from measured per-site demand on the
    # ladder {2^k} ∪ {3·2^(k-1)}, grown at once, shrunk after
    # exchange_shrink_patience calm drains; off = the worst-case formula
    exchange_occupancy_sizing: bool = True
    # granted cap = ladder_ceil(measured peak demand × headroom)
    exchange_headroom: float = 1.5
    exchange_shrink_patience: int = 4
    # per-destination caps and one receive rung: "auto" engages them only
    # where narrower than the n·cap layout; "always"/"never" force
    exchange_per_dest: str = "auto"
    # fused sources with static key sets pack home-block-local on the
    # host at window build, so their exchange plans cap 0
    exchange_align_sources: bool = True
    # unfused: pre-dispatch the exchange of queued batches with cached
    # rows at round start (exact: the exchange reads no arena state)
    exchange_overlap: bool = True
    # worst-case fallback plan before any demand is measured: bucket
    # floor (lanes) times the skew allowance over the uniform share
    exchange_pad_quantum: int = 256
    exchange_capacity_factor: float = 2.0
    # max parked optimistic miss-checks before a forced (synchronizing)
    # drain — bounds device memory pinned by deferred delivery checks
    miss_check_cap: int = 16
    # auto-fusion (tensor/autofuse.py): after auto_fusion_ticks
    # consecutive ticks with an identical injection pattern the engine
    # runs the steady tick as fused windows of auto_fusion_window ticks —
    # on the card one replay of a captured CUDA graph per window — and
    # rolls back (exactly) on any miss.  0 disables detection.
    auto_fusion_ticks: int = 16
    auto_fusion_window: int = 16
    # rollback hysteresis: after this many rolled-back windows for one
    # signature the pattern is banned (until its generation changes)
    auto_fusion_max_rollbacks: int = 3
    # windows per exactness-verification sync: the device miss counter
    # is read once per this many windows, so a rollback replays up to
    # verify_windows * window ticks; 1 = verify every window
    auto_fusion_verify_windows: int = 4
    # idle grace before the engine loop replays a partially-filled
    # window unfused
    auto_fusion_idle_flush: float = 0.02
    # device timers plane (tensor/timers_plane.py): the per-tick harvest
    # of the hierarchical timing wheel; off = armed timers stop firing
    # (the wheel catches up on re-enable)
    timers_plane: bool = True
    # wheel level widths in bits, lowest first: 256 one-tick buckets,
    # 64 of 256 ticks, 64 of 16384 ticks, then the overflow list
    timers_wheel_bits: tuple = (8, 6, 6)
    # tick jump beyond which advance_to rebuilds the wheel from the live
    # slot mirrors (O(armed)) instead of stepping tick by tick
    timers_catchup_jump: int = 4096
    # arm/cancel rows the timers' delta op log may hold between checkpoint
    # cuts; overflow promotes the next timers export to a full
    timers_ops_cap: int = 1 << 18
    # ---- durable state plane (tensor/checkpoint.py) ----
    # full-arena columnar checkpoint cadence (ticks; 0 = explicit only): a
    # consistent cut pinned at a tick boundary (K19), then drained
    # device→host in chunks between ticks.  Engaged only when a
    # SnapshotStore is attached.
    ckpt_full_every_ticks: int = 0
    # incremental deltas between fulls (ticks; 0 = none): only rows whose
    # traffic counts or use clocks moved since the last committed cut
    # (K21) re-checkpoint; a generation change promotes the next delta to
    # a full
    ckpt_delta_every_ticks: int = 0
    # rows per drain chunk: one K20 gather and one device→host copy each
    ckpt_chunk_rows: int = 65536
    # per-tick snapshot-drain pause budget (seconds); <= 0 drains the
    # whole pinned snapshot in one slice (the synchronous baseline)
    ckpt_pause_budget_s: float = 0.005
    # journal capacity per journaled (type, method) site (lanes, pow2-
    # rounded): a batch that would overflow it seals the open segment
    # first (counted as a ring overflow)
    journal_ring_lanes: int = 65536
    # journal segment seal cadence (ticks; 0 = seal only at checkpoints,
    # ring overflow or an explicit flush).  A seal is the durability
    # acknowledgement point: lanes past the last sealed segment are the
    # loss window of a hard kill.
    journal_flush_every_ticks: int = 0
    # recover from the snapshot store at silo startup (read by the host
    # integration; ``CheckpointPlane.recover`` is the entry point)
    durable_recovery: bool = True
    # journal tail fold-replay window (ticks): runs of consecutive
    # journaled ticks with one per-site signature replay as one stacked
    # fused window; <= 1 replays tick by tick
    recover_fused_window: int = 64
    # re-anchor after recover(): "sync" writes a fresh full inside it,
    # "defer" leaves the old recovery point for the cadence to replace
    recover_reanchor: str = "defer"
    # periodic VectorStore write-back of every live row (ticks; 0 = only
    # explicit ``checkpoint()``)
    checkpoint_every_ticks: int = 0
    # device streams plane (tensor/streams_plane.py): registered
    # stream-subscription routes expand on the device — pull-mode (one
    # payload gather per edge + the row-range reductions of K16) when the
    # publish pattern is the bound key set, push-mode (K11) otherwise.
    # Off = the host-expansion baseline (a device→host copy per publish
    # and a numpy adjacency walk).  A live toggle rebuilds fused windows.
    stream_plane: bool = True
    # cross-silo sender aggregation (tensor/router.py): slab fragments of
    # one drain cycle merge into one frame per (destination, type,
    # method); off = every fragment is its own frame (the A/B baseline)
    slab_aggregation: bool = True
    # seconds a silo defers first-touch activation after a ring change
    # while awaiting its peers' handoff releases (tensor/router.py)
    handoff_fence_timeout: float = 2.0


@dataclass
class MetricsConfig:
    """Metrics knobs: the on-device latency ledger (tensor/ledger.py) and
    the workload-attribution plane (tensor/attribution.py)."""

    # per-(type, method) log2 histograms of inject→completion tick
    # deltas, accumulated on the device; only the small bucket-count
    # array crosses device→host, at an explicit snapshot
    ledger_enabled: bool = True
    # bucket 0 = completed in the inject tick, bucket k = [2**(k-1), 2**k)
    # ticks, the last bucket absorbs overflow
    ledger_buckets: int = 16
    # workload attribution plane (tensor/attribution.py): per-row traffic
    # counts + count-min sketch + per-method slots accumulated on the
    # device; a toggle or sketch-layout change rebuilds fused windows
    attribution_enabled: bool = True
    # hot grains published per snapshot (the device top-K of the counts)
    attribution_top_k: int = 16
    # count-min sketch layout: est - true <= (e/width)*N with probability
    # >= 1 - exp(-depth); 4x8192 int32 = 128KB per arena
    attribution_cms_depth: int = 4
    attribution_cms_width: int = 8192


@dataclass
class LivenessConfig:
    """(reference: GlobalConfiguration liveness section :149-194)"""

    probe_timeout: float = 0.5            # ProbeTimeout
    table_refresh_timeout: float = 5.0    # TableRefreshTimeout
    death_vote_expiration: float = 120.0  # DeathVoteExpirationTimeout
    iam_alive_table_publish: float = 5.0  # IAmAliveTablePublishTimeout
    num_missed_probes_limit: int = 3      # NumMissedProbesLimit
    num_probed_silos: int = 3             # NumProbedSilos
    num_votes_for_death: int = 2          # NumVotesForDeathDeclaration
    probe_period: float = 1.0
    # per-peer gossip RPC timeout (also bounds the shutdown goodbye wait)
    gossip_timeout: float = 1.0
    # fast-suspect: a non-quorum suspect vote gossips the suspicion so
    # other members probe the victim now and add their votes
    fast_suspect: bool = True


@dataclass
class DirectoryConfig:
    """(reference: GlobalConfiguration directory section :247-275)"""

    buckets_per_silo: int = 30            # virtual-bucket ring


@dataclass
class MessagingConfig:
    response_timeout: float = 30.0        # ResponseTimeout
    max_forward_count: int = 2            # MaxForwardCount


@dataclass
class RebalanceConfig:
    """The rebalance knob the ring-change handoff reads."""

    # on a ring change, push the rows a silo no longer owns to their new
    # owner (one adopt_grains slab per destination, FIFO before the
    # handoff release) under the store write-back; off = the pure
    # evict-and-miss handoff
    handoff_migration: bool = True


@dataclass
class SiloConfig:
    """A clustered silo's configuration (the sub-configs the vector data
    plane reads; ``orleans_tpu``'s SiloConfig carries the rest)."""

    name: str = "silo"
    liveness: LivenessConfig = field(default_factory=LivenessConfig)
    directory: DirectoryConfig = field(default_factory=DirectoryConfig)
    messaging: MessagingConfig = field(default_factory=MessagingConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    rebalance: RebalanceConfig = field(default_factory=RebalanceConfig)
    tensor: TensorEngineConfig = field(default_factory=TensorEngineConfig)
