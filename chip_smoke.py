#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: Presence, WidePresence, Chirper, the
grain lifecycle, the timers plane, the streams plane, hot-grain replicas
(the routing sample), GPSTracker, TwitterSentiment, the durable state
plane (checkpoints, journal, recovery, warm standby), clustered silos
(the cross-silo vector data plane) and shard blocks with the cross-shard
exchange (the routing sample's ratio sweep) on one NVIDIA card.

Run from the repository root on a machine with an H100 and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which fails loudly (exit code other than 0):

1. The card: ``nvidia-smi``'s name and power limit.  No card, no run.
2. Build: every kernel source in ``orleans_tpu_torch/csrc`` with ``nvcc``
   for ``sm_90a``, one compiler per source, all started together.
3. Kernels against their plain PyTorch versions on the card, at the
   shapes of Presence with 1,000,000 players and 10,000 games, on the
   main path's inputs and on adversarial inputs (padding rows -1, rows
   past the end, sentinel, negative, out-of-range and unseen keys, more
   unique misses than the drain's buffer); the attribution kernels K7–K9
   in every mode the plane uses (``check_attr_kernels``); K4 on every
   path (direct, privatized blocks flushing alone, clusters of 2 and 8)
   at Presence's game fan-in and at the routing sample's 256 sinks
   and hot sink (1,048,576 lanes on 1,024 rows), its zero fill timed
   apart; K3 on every op and dtype, with the path ``scatter_plan`` chose,
   the routing sample's touch of its 256 sinks and of its hot sink
   included; K1 with the wrapper's fresh miss counter and into a given
   one; K8 on views whose words start past a 16-byte line, end short
   of one, or differ from their delta's modulo 16.  Integers must
   match exactly; float32 sums within Higham's bound for recursive
   summation (see ``_fan_in_tol``).  Each kernel is timed (median of
   CUDA-event times over 25 launches, L2 flushed before each) beside its
   plain version, one PyTorch library call as a yardstick, and its
   bound: the larger of the bytes it must move over 3.35 TB/s and its
   operations over the card's peak rate.  The two programs kept as plain
   PyTorch (``accumulate``, ``_stack_counts``) are timed too.
4. The unfused path: ``run_presence_load`` on ``TensorEngine(device=
   "cuda")`` with auto-fusion off, at 1M players / 10k games, a pipelined
   run, a ``measure_latency`` run and a loader that hands over a fresh
   copy of the games every tick, each checked exactly against a numpy
   oracle of the seeded load, the attribution plane included
   (``check_attribution``).
5. The fused path, at the default config (auto-fusion, the latency
   ledger and the attribution plane on): 3 warm ticks, the detection
   ticks, then 8 windows of 16 ticks, each window one CUDA graph replay —
   once pipelined, once synced per window — and a run that forces one
   rollback with a cold game key inside a window.  Each is checked against the oracle, and the ledger
   histogram and the attribution plane against the counts the run
   implies.  The plane's device cost per tick is timed against engines
   without it, unfused and fused; so is the parked miss-check's copy.
   Launch counters are zeroed just before each path and read just after
   (the fused path: the pipelined run and the rollback run); every kernel
   must have launched on each path (graph replays count the launches
   their capture recorded).
6. Wide keys: WidePresence, 1,000,000 players over 10,000 wide game keys
   (jenkins hashes, ``(hi, lo)`` words resolved by K10), player 0 on a
   game that is never pre-activated (its warm ticks' updates miss and go
   again through the exact host path), unfused and then auto-fused at the
   default config; heartbeats and updates exact against the numpy oracle,
   total_score within Higham's bound, the ledger and the attribution
   plane exact.
7. The follower fan-out: Chirper, 200,000 accounts, mean 25 followers,
   Zipf 1.6, seed 0 (2,011,069 edges; the graph built once and shared),
   unfused, then auto-fused at the default config, then a ``follow()``
   while ticks are buffered (they run first on the old graph; the next
   window rebuilds on the new one); per account ``published``,
   ``received``, ``last_chirp`` exact and ``checksum`` within Higham's
   bound, the ledger and the attribution plane exact.  K10 and K11 are
   checked against their plain versions first (phase 3), at the paths'
   shapes, on colliding wide hashes, edge words, padding and the
   narrow-into-wide mode, on the empty graph and on a round whose
   duplicate sources overflow the width.  Each path's launch counters are
   zeroed just before it and read just after; every kernel of the path
   must have launched (graph replays count).
8. The grain lifecycle and the timers plane.  K12–K15 against their
   plain versions on the card at the paths' shapes and on adversarial
   inputs (clocks and cutoffs at the clipped int32 edges, pad lanes,
   out-of-range slots, dues and clocks where int32 arithmetic wraps, a
   harvest with re-arms, one-shots and stale slots, an empty harvest),
   each timed beside its bound.  Collection at bench.py's full size
   (``_collection_tier``): 500,000 Presence players on 5,000 games,
   50,000 hot, ``collection_idle_ticks=60``, every 16 ticks, 16,384-row
   chunks, a ``MemoryVectorStore``, the attribution plane on, auto-fusion
   off — incremental (0.02 s pause budget), synchronous (budget 0), both
   with compaction off, and once at the default threshold 0.75, which
   crosses into ``_compact``.  Each is exact: 450,000 evicted, every live
   row and every evicted key's store record equal the numpy oracle, the
   probe key re-activates with its state, the attribution totals equal
   the per-key message counts.  The timers: 2,000,000 AuctionGrain
   one-shots striped over 64 ticks (each fires once, on its tick), the
   auction sample at 1,000,000 and the watchdog at 500,000, exact against
   their oracles; and the watchdog at 50,000 with collection on (silent
   devices evicted between watches, re-activated by the watch fires),
   held against the same run on the CPU engine (which
   tests/test_torch_timers.py holds against the JAX engine).  Launches
   are counted per path.
9. The device streams plane (``drive_streams_path``), at bench.py's full
   ``_streams_tier`` size.  K16 ``seg_pull`` and K17 ``touch_dense``
   against their plain versions on the card, on the chat headline's pull
   layout (1,000,000 users, 4,096 rooms, 1.5 memberships: 1,461,322
   lanes): int32 sums (the checksum lanes, a batch whose running total
   crosses 2**31, full-range values), an int32 max with ``fill=-1`` over
   masked lanes and empty rows, a float32 sum within ``2 * k * 2**-24 *
   sum|x|`` per row of ``k`` lanes, the count mode with a slot total, and
   K17; each mode timed beside its bound, its plain version and
   ``torch.segment_reduce`` where it takes the type.  Then chat unfused
   (8 ticks, the sample's oracle exact in all three fields, every
   delivery pull-mode) with events/s and a tick's device and host time;
   the fused chat headline (96 ticks, windows of 16, ``verify() == 0``,
   every member's ``received``, ``last_msg`` and ``checksum`` equal to a
   numpy replay of the stacked message ids over ``host_expand``) with a
   window's device time and the idle share; leaderboards (512 boards,
   1,000,000 members, 1.5 follows, 24 ticks, oracle on); and the churn
   exactness of ``_streams_churn_exactness`` at 100,000 users, 256 rooms,
   2.0 memberships (subscribe, unsubscribe, 10% evicted through a
   ``MemoryVectorStore`` and their rows reused clean, the plane off and
   on, exact at every point).  Launches counted per path.
10. Hot-grain replicas, GPSTracker and TwitterSentiment.  K18
   ``spread_replicas`` against its plain version and the arena's host
   twin ``spread_rows_host``, bit for bit, on 1,048,576 lanes with
   misses over G = 1, 3 and 9 replica groups of k = 2 and 8 rows, timed
   at the hot-grain shape beside its bound, its plain version and the
   searchsorted + index_select + where composite.  The routing sample at
   bench.py ``_single_hot_grain_tier``'s shape with 1,048,576 sources (the
   tier's 131,072 was sized for a CPU mesh) and 256 sinks, ledger and
   attribution plane on: five unfused arms (uniform; every source to one
   sink unreplicated, at k = 2 and at k = 8; uniform through the live
   k = 8 group), each with its device and host ms per tick, K4's share
   (K4 timed alone on the arm's rows) and K18's launches; then fused
   windows of 16 at k = 8 with a demote and a re-promote between them,
   each a graph rebuild (cause ``replica_change``).  ``received`` equals
   ``expected_sink_state`` through the fold and ``total`` lies within
   ``2 * n * 2**-24 * sum|x|`` after every arm, promote and demote, and a
   demoted sink's one row equals its fold.  GPSTracker at 200,000
   devices (unfused 20 ticks; fused 20 ticks in windows of 10) against a
   numpy oracle: moves, fixes and notifier counts exact, speed within a
   relative 1e-5.  TwitterSentiment at 100,000 tweets / 20,000 hashtags
   (unfused and fused, 20 ticks) and the grouped pull path at 50,000 /
   10,000 (10 ticks): sums, ``counted`` and the counter exact against a
   numpy oracle, ``last_score`` one of its tag's last-tick scores on the
   scatter path and its last lane exactly on the grouped path, grouped
   equal to ungrouped.  Every earlier path must count 0 K18 launches.
11. The durable state plane (``drive_durability_path``), at the shapes of
   bench.py ``--workload durability`` on one card.  K19 ``pin_columns``,
   K20 ``gather_columns`` and K21 ``dirty_mask`` against their plain
   versions bit for bit (K19 on 4,194,304 rows of the Presence arena's
   columns plus a bool and an ``[n, 3]`` column; K20 on 65,536-row drain
   chunks and a short chunk padded to a power of two, its copy off the
   card timed apart; K21 on 4,194,304 rows in both modes, clocks equal to
   the cutoff among them), each timed beside its bound, its plain version
   and a library yardstick.  Then: the restore probe (4,000,000 players
   and 40,000 games through ``run_presence_load_fused``, a full drained
   into a ``MemorySnapshotStore``, a hard kill, ``recover()`` on a fresh
   engine, best of two each way, identity and every column equal); the
   same at 1,000,000 through a ``FileSnapshotStore``; the live cadence at
   1,000,000 unfused and auto-fused (fulls every 32 ticks, deltas every 8,
   a 5 ms pause budget, the heartbeat journaled and sealed every 4 ticks,
   64 ticks traced with ``torch.profiler`` against an engine without the
   plane, then killed and recovered at the acknowledged horizon); the
   journal fold (banking, 50,000 accounts, 240 events of 32,768 lanes, no
   overflow seal, fused replay windows of 64, equal to ``BankOracle`` and
   conserved); the warm standby at 4,000,000 (``StandbyTailer`` adopting
   the full while ``AccountGrain.deposit`` traffic over 256 keys runs 17
   ticks, promote, RTO, the acknowledged prefix exact, the old primary
   fenced).  Launches counted per arm; no arm may launch K18.
12. Clustered silos on the card (``drive_cluster_path``).  K22
   ``gather_args`` against its plain version piece by piece: the
   Presence payload (game, score, tick: 12 B a lane) at 1,048,576 lanes
   split 2 and 3 ways by real ring ownership, each remote region fetched
   with one copy, ``m = 0``, an ``[n, 4]`` float32 and an int64 leaf;
   timed at the 2-way split beside its bound, its plain version and the
   ``index_select`` loop.  Then Presence 1M/10k on a 2-silo
   ``TestingCluster`` of the port (in-process transport with wire
   fidelity, every engine on the card): a warm-up, 20 ticks through
   ``run_presence_load``'s cluster injector with device payloads (K22
   every inject; remote games miss through K6 and ship), 8 ticks traced
   with ``torch.profiler`` ranges per silo (host and device ms per tick
   per silo), 64 ticks of each silo's own players on its own games
   (auto-fused windows on both silos), then a third silo joins (the
   handoff pushes the strays, the fence settles; its wall time) and 10
   ticks run split 3 ways.  Every stage is exact against a numpy oracle
   with no key live on two silos.  Then bench.py ``_cluster_presence``'s
   drive on a fresh 2-silo cluster: 8 uneven host fragments a tick,
   sender aggregation on, 10 ticks, exact (merge ratio, codec bytes).
   Launches counted per arm; K22 must launch there and nowhere earlier.
13. Shard blocks and the cross-shard exchange (``drive_exchange_path``),
   8 blocks of one arena on the card.  K23 ``exchange_classify`` (probe
   and cap-0 modes) and K24 ``exchange_buckets`` (legacy and
   per-destination layouts, fitting and overflowing on either side)
   against their plain versions bit for bit, at 4,000,000 lanes padded to
   4,194,304, with the caps the sweep's estimator grants and 4-byte,
   8-byte and 2-D leaves, each timed beside its bound, its plain version
   and a library composite.  Then the routing sample's ratio sweep at
   bench.py ``_multichip_tier``'s full size (4,000,000 sources, 524,288
   sinks, ratios 0.9, 0.5, 0.1 and 0, 12 unfused ticks and fused windows
   of 4) in three arms — the structured exchange ("always", the legacy
   layout pinned), exchange off, and "auto" (disengaged on one card:
   identity plus the sampled probe) — each exact against
   ``expected_sink_state``, the structured arm's sink leg crossing exactly
   round(ratio * n) lanes a tick with every lane delivered; messages/s per
   ratio and the device ms of a tick and a window at ratio 0.5.  Then the
   throughput point (262,144 / 8,192, ratio 0.1, windows of 64), the
   per-destination arm, the overflow arm (a grant shrunk to cap 0, then
   ratio 0.9: dropped lanes delivered again with their original stamp,
   late lanes in the ledger) and the migration arm (52,429 sinks and 4,096
   sources moved with pins while a tick is queued, exact against a
   never-migrated engine, every mover in its pinned block, the move's
   gathers and sets counted).  No earlier path may launch K23 or K24.
14. One JSON line of the kernels, the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import gc
import json
import math
import sys
import time

import numpy as np
import torch

PLAYERS, GAMES = 1_000_000, 10_000
WARM_TICKS, TICKS = 3, 20
WINDOWS = 8                    # fused windows per fused run
COLD_GAME = GAMES + 7          # a game key no player starts in
REPS = 25
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT32_OPS_PER_S = 33.5e12      # integer ALU: half the 67 TFLOP/s float32 rate
SENTINEL = 2**31 - 1
WIDE_GAMES = 10_000            # WidePresence: PLAYERS players, wide games
ACCOUNTS, MEAN_FOLLOWERS, ZIPF = 200_000, 25.0, 1.6   # Chirper
NEW_WINDOWS = 4                # fused windows per new path's timed run
# collection (bench.py _collection_tier, full size)
COLL_GRAINS, COLL_HOT, COLL_GAMES = 500_000, 50_000, 5_000
COLL_IDLE, COLL_EVERY, COLL_BUDGET, COLL_CHUNK = 60, 16, 0.02, 16_384
# timers (bench.py _timers_tier, full size)
TIMERS_N, TIMERS_SPREAD = 2_000_000, 64
AUCTIONS, FLEET, COMPOSED_FLEET = 1_000_000, 500_000, 50_000
# streams (bench.py _streams_tier and _streams_churn_exactness, full size)
CHAT_USERS, CHAT_ROOMS, CHAT_MEAN = 1_000_000, 4_096, 1.5
CHAT_TICKS, CHAT_FUSED_TICKS = 8, 96
BOARDS, BOARD_MEMBERS, BOARD_MEAN, BOARD_TICKS = 512, 1_000_000, 1.5, 24
CHURN_USERS, CHURN_ROOMS, CHURN_MEAN = 100_000, 256, 2.0
# hot-grain replicas: bench.py _single_hot_grain_tier's routing shape (all
# sources to one of 256 sinks) at the Presence-scale population
HOT_SOURCES, HOT_SINKS, HOT_TICKS, HOT_WINDOWS = 1_048_576, 256, 20, 4
SINK_ROWS = 1024               # the sink arena's capacity at 256 sinks
SPREAD_LANES = 1_048_576
# GPSTracker (bench.py --devices) and TwitterSentiment (bench.py
# --tweets-per-tick / --hashtags; _streams_twitter for the grouped path)
GPS_DEVICES, GPS_TICKS, GPS_WINDOW = 200_000, 20, 10
TW_TWEETS, TW_TAGS, TW_TICKS, TW_WINDOW = 100_000, 20_000, 20, 10
TWG_TWEETS, TWG_TAGS, TWG_TICKS = 50_000, 10_000, 10
# the durable state plane (bench.py --workload durability, _durability_tier)
CKPT_ROWS, CKPT_CHUNK = 4_194_304, 65_536      # K19/K21 rows, K20 chunk
RESTORE_PLAYERS = 4_000_000                      # restore probe, standby
CADENCE_TICKS = 64
FOLD_ACCOUNTS, FOLD_EVENTS, FOLD_LANES = 50_000, 240, 32_768
# clustered silos (tests/test_cross_silo_presence.py's deployment shape and
# bench.py --workload cluster at PLAYERS / GAMES)
K22_LANES = 1_048_576
TRACE_TICKS, FUSED_CLUSTER_TICKS, JOIN_TICKS, FRAG_TICKS = 8, 64, 10, 10
# the cross-shard exchange: bench.py _multichip_tier's full size over 8
# shard blocks of one card; ratios in descending order (see _ex_sweep_arm)
EX_BLOCKS = 8
EX_SOURCES, EX_SINKS, EX_TICKS, EX_WINDOW = 4_000_000, 524_288, 12, 4
EX_RATIOS = (0.9, 0.5, 0.1, 0.0)
EX_TP = (262_144, 8_192, 0.1, 128, 64)   # sources, sinks, ratio, ticks, window
EX_MOVERS = 52_429                       # 10% of the sinks

SOURCES = {
    "resolve_dense": ("orleans_tpu_torch/csrc/resolve.cu",
                      "orleans_tpu/tensor/engine.py:233"),
    "resolve_sorted": ("orleans_tpu_torch/csrc/resolve.cu",
                       "orleans_tpu/tensor/engine.py:218"),
    "row_scatter": ("orleans_tpu_torch/csrc/scatter.cu",
                    "orleans_tpu/tensor/vector_grain.py:238"),
    "seg_sum": ("orleans_tpu_torch/csrc/segment.cu",
                "orleans_tpu/tensor/vector_grain.py:164"),
    "hist_count": ("orleans_tpu_torch/csrc/hist.cu",
                   "orleans_tpu/tensor/ledger.py:98"),
    "miss_keys": ("orleans_tpu_torch/csrc/miss.cu",
                  "orleans_tpu/tensor/engine.py:333"),
    "attr_fold": ("orleans_tpu_torch/csrc/attr_fold.cu",
                  "orleans_tpu/tensor/attribution.py:113"),
    "attr_apply": ("orleans_tpu_torch/csrc/attr_apply.cu",
                   "orleans_tpu/tensor/attribution.py:192"),
    "attr_match": ("orleans_tpu_torch/csrc/attr_apply.cu",
                   "orleans_tpu/tensor/attribution.py:205"),
    "attr_snapshot": ("orleans_tpu_torch/csrc/attr_snapshot.cu",
                      "orleans_tpu/tensor/attribution.py:257"),
    "resolve_wide": ("orleans_tpu_torch/csrc/resolve_wide.cu",
                     "orleans_tpu/tensor/engine.py:265"),
    "fanout_expand": ("orleans_tpu_torch/csrc/fanout.cu",
                      "orleans_tpu/tensor/fanout.py:52"),
    "idle_mask": ("orleans_tpu_torch/csrc/lifecycle.cu",
                  "orleans_tpu/tensor/arena.py:53"),
    "gather_rows": ("orleans_tpu_torch/csrc/lifecycle.cu",
                    "orleans_tpu/tensor/attribution.py:287"),
    "timers_write": ("orleans_tpu_torch/csrc/timers.cu",
                     "orleans_tpu/tensor/timers_plane.py:80"),
    "timers_harvest": ("orleans_tpu_torch/csrc/timers.cu",
                       "orleans_tpu/tensor/timers_plane.py:90"),
    "seg_pull": ("orleans_tpu_torch/csrc/pull.cu",
                 "orleans_tpu/tensor/vector_grain.py:164"),
    "touch_dense": ("orleans_tpu_torch/csrc/pull.cu",
                    "orleans_tpu/tensor/arena.py:43"),
    "spread_replicas": ("orleans_tpu_torch/csrc/replicas.cu",
                        "orleans_tpu/tensor/arena.py:61"),
    "pin_columns": ("orleans_tpu_torch/csrc/checkpoint.cu",
                    "orleans_tpu/tensor/checkpoint.py:81"),
    "gather_columns": ("orleans_tpu_torch/csrc/checkpoint.cu",
                       "orleans_tpu/tensor/checkpoint.py:90"),
    "dirty_mask": ("orleans_tpu_torch/csrc/checkpoint.cu",
                   "orleans_tpu/tensor/checkpoint.py:97"),
    "gather_args": ("orleans_tpu_torch/csrc/router.cu",
                    "orleans_tpu/tensor/router.py:49"),
    "exchange_classify": ("orleans_tpu_torch/csrc/exchange.cu",
                          "orleans_tpu/tensor/exchange.py:83"),
    "exchange_buckets": ("orleans_tpu_torch/csrc/exchange.cu",
                         "orleans_tpu/tensor/exchange.py:656"),
}
# K6 and K11 before their redesign for the H100 (the previous kernels:
# K6 a table fill, a CAS per missing lane and a cooperative bitonic sort;
# K11 a scan in three launches and a binary search per slot), by
# probe_k6_k11.py on an NVIDIA H100 80GB HBM3 at 700.00 W (the mean of two
# runs' medians of 25, L2 flushed), by (kernel, variant; None for the
# main shape): printed beside this run's times at the same shapes, in the
# readable lines only (the kernels line holds what this run measured)
PREVIOUS_MS = {("miss_keys", None): 0.0776,
               ("miss_keys", "cluster_inject"): 0.0604,
               ("fanout_expand", None): 0.0640,
               ("fanout_expand", "streams_push"): 0.0425}
# the kernels each path must launch (launch counts zeroed before it, read
# after it)
PRESENCE_KERNELS = ("resolve_dense", "resolve_sorted", "row_scatter",
                    "seg_sum", "hist_count", "miss_keys", "attr_fold",
                    "attr_apply", "attr_match", "attr_snapshot")
WIDE_KERNELS = ("resolve_wide", "row_scatter", "seg_sum", "hist_count",
                "attr_fold")
CHIRPER_KERNELS = ("fanout_expand", "resolve_dense", "row_scatter",
                   "seg_sum", "hist_count", "attr_fold")
COLLECTION_KERNELS = ("idle_mask", "gather_rows", "row_scatter", "seg_sum",
                      "attr_fold")
TIMERS_KERNELS = ("timers_write", "timers_harvest", "gather_rows",
                  "row_scatter", "resolve_dense")
COMPOSED_KERNELS = ("idle_mask", "gather_rows", "timers_write",
                    "timers_harvest", "row_scatter", "miss_keys")
STREAMS_UNFUSED_KERNELS = ("seg_pull", "touch_dense", "seg_sum",
                           "row_scatter", "hist_count", "attr_fold")
STREAMS_FUSED_KERNELS = ("seg_pull", "seg_sum", "row_scatter", "hist_count",
                         "attr_fold")
STREAMS_CHURN_KERNELS = ("seg_pull", "touch_dense", "gather_rows",
                         "row_scatter")
ROUTING_HOT_KERNELS = ("spread_replicas", "resolve_sorted", "seg_sum",
                       "row_scatter", "hist_count", "attr_fold")
GPS_KERNELS = ("gather_rows", "row_scatter", "seg_sum", "resolve_dense",
               "hist_count", "attr_fold")
TWITTER_UNFUSED_KERNELS = ("resolve_dense", "seg_sum", "row_scatter",
                           "hist_count", "attr_fold")
TWITTER_KERNELS = ("resolve_sorted", "resolve_dense", "seg_sum",
                   "row_scatter", "hist_count", "attr_fold")
TWITTER_GROUPED_KERNELS = ("seg_pull", "resolve_sorted", "seg_sum",
                           "hist_count", "attr_fold")
# every durability arm also launches resolve_dense or resolve_sorted
DURABILITY_KERNELS = ("pin_columns", "gather_columns", "dirty_mask",
                      "row_scatter")
CLUSTER_KERNELS = ("gather_args", "miss_keys", "seg_sum", "row_scatter",
                   "gather_rows")
ALSO_REPLACES = {"row_scatter": ["orleans_tpu/tensor/vector_grain.py:253",
                                 "orleans_tpu/tensor/arena.py:34",
                                 "orleans_tpu/tensor/attribution.py:294",
                                 "orleans_tpu/tensor/arena.py:634",
                                 "orleans_tpu/tensor/arena.py:877"],
                 "gather_rows": ["orleans_tpu/tensor/arena.py:702",
                                 "orleans_tpu/tensor/arena.py:768"],
                 "hist_count": ["orleans_tpu/tensor/fused.py:384"],
                 "resolve_wide": ["orleans_tpu/tensor/engine.py:248"],
                 "pin_columns": ["orleans_tpu/tensor/checkpoint.py:1072"],
                 "dirty_mask": ["orleans_tpu/tensor/checkpoint.py:109"],
                 "seg_pull": ["orleans_tpu/tensor/vector_grain.py:194",
                              "orleans_tpu/tensor/attribution.py:133"],
                 "exchange_classify": ["orleans_tpu/tensor/exchange.py:101",
                                       "orleans_tpu/tensor/exchange.py:405"],
                 "exchange_buckets": ["orleans_tpu/tensor/exchange.py:772",
                                      "orleans_tpu/tensor/exchange.py:720",
                                      "orleans_tpu/tensor/exchange.py:851",
                                      "orleans_tpu/tensor/exchange.py:964"],
                 "attr_fold": ["orleans_tpu/tensor/attribution.py:133",
                               "orleans_tpu/tensor/attribution.py:161",
                               "orleans_tpu/tensor/attribution.py:174",
                               "orleans_tpu/tensor/fused.py:387",
                               "orleans_tpu/tensor/fused.py:739"]}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def _fan_in_tol(values: np.ndarray, rows: np.ndarray, n_rows: int,
                base: np.ndarray = None) -> np.ndarray:
    """Per row, twice Higham's bound for recursive summation,
    ``2 * (k - 1) * 2**-24 * sum|x|`` over the k terms summed into the row
    (the kept lanes, plus ``base``, the column's value before an in-place
    add): both sides of the comparison are float32 sums taken in
    different (atomic) orders."""
    keep = (rows >= 0) & (rows < n_rows)
    k = np.bincount(rows[keep], minlength=n_rows)
    mag = np.bincount(rows[keep], weights=np.abs(values[keep]).astype(
        np.float64), minlength=n_rows)
    if base is not None:
        k = k + 1
        mag = mag + np.abs(base)
    return 2 * np.maximum(k - 1, 0) * 2.0**-24 * mag


class Timer:
    """Median device time of a callable over ``REPS`` runs, and the median
    host time it takes to enqueue its work.

    Before each run the L2 is flushed and the stream is held by a spin
    kernel (``torch.cuda._sleep``) long enough for the host to enqueue the
    whole call, so the CUDA-event window holds the call's device work back
    to back, not the Python launch overhead of its wrapper.  A call that
    synchronises inside (the plain versions' boolean indexing) still shows
    its own host round trips."""

    SPIN_CYCLES = 4_000_000  # a few ms at any SM clock

    def __init__(self, device):
        # larger than the 50 MB L2: writing it evicts the inputs
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
        self.host_ms = 0.0

    def __call__(self, fn, reps: int = REPS, setup=None) -> float:
        """``setup``, where given, runs before every run and outside its
        window: it restores state that ``fn`` changes in place."""
        if setup is not None:
            setup()
        fn()  # warm: first launch loads the module
        torch.cuda.synchronize()
        times, host = [], []
        for _ in range(reps):
            if setup is not None:
                setup()
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        self.host_ms = float(np.median(host))
        return float(np.median(times))


def measure(timer, kernel, plain, library, setup=None) -> dict:
    """Device times of the kernel's wrapper, its plain version and the
    library yardstick (None where no one PyTorch call computes the same
    function), plus the host time the wrapper takes to enqueue.  ``setup``
    restores, before every timed run, what the calls change in place."""
    ms = timer(kernel, setup=setup)
    host_ms = timer.host_ms
    return dict(ms=ms, host_ms=host_ms, plain_ms=timer(plain, setup=setup),
                library_ms=timer(library, setup=setup)
                if library is not None else None)


def bound(bytes_moved: float, int_ops: float = 0.0):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wide_bound(n_keys: int, lanes: int, narrow: bool = False):
    """K10's bound: each live key's hash, row and two key words read once
    (16 B: the padding and the free rows are not needed), each lane's
    words, valid flag and row (13 B, 9 in narrow mode), the miss count;
    and a search of ceil(log2(n_keys + 1)) steps a lane."""
    steps = math.ceil(math.log2(n_keys + 1))
    return bound(16 * n_keys + lanes * (9 if narrow else 13) + 4,
                 int_ops=lanes * (2 * steps + 24))


def match_stacks(plan_rows, plan_valid, k: int, odd: bool = False):
    """K8's match inputs: ``k`` entries equal to the plan (rows, valid),
    as clones, or with ``odd`` as rows of one longer buffer each, one word
    (rows) and one byte (valid) past a 16-byte boundary."""
    if not odd:
        return ([plan_rows.clone() for _ in range(k)],
                [plan_valid.clone() for _ in range(k)])
    m = plan_rows.shape[0]
    big_r = torch.cat([plan_rows[:1], plan_rows]).repeat(k).view(k, m + 1)
    big_v = torch.cat([plan_valid[:1], plan_valid]).repeat(k).view(k, m + 1)
    return ([big_r[e, 1:] for e in range(k)],
            [big_v[e, 1:] for e in range(k)])


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(dev, timer, card: str):
    from orleans_tpu_torch.kernels import hist, miss, resolve, scatter, segment
    from orleans_tpu_torch.samples.presence import presence_inputs
    from orleans_tpu_torch.tensor.engine import MISS_BUF

    rng = np.random.default_rng(1234)
    _, games, scores = presence_inputs(PLAYERS, GAMES, seed=0)
    cap_p, cap_g, dense_n = 1 << 21, 1 << 15, 1 << 14  # arena shapes
    m = PLAYERS

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    games_d, scores_d = t(games), t(scores)
    valid_d = torch.ones(m, dtype=torch.bool, device=dev)
    # the main path's rows: players activate in key order, games too
    prow_d = torch.arange(m, dtype=torch.int32, device=dev)
    prow64_d = prow_d.long()
    grow_d = games_d  # game g lives in row g
    grow64_d = grow_d.long()

    def adversarial_keys(key_hi):
        keys = rng.integers(0, key_hi, m).astype(np.int32)
        odd = rng.random(m)
        keys[odd < 0.05] = SENTINEL
        keys[(odd >= 0.05) & (odd < 0.08)] = -5
        keys[(odd >= 0.08) & (odd < 0.1)] = key_hi + 77
        return t(keys), t(rng.random(m) < 0.9)

    def adversarial_rows(n, unique):
        rows = rng.permutation(n)[:m] if unique else rng.integers(0, n, m)
        rows = rows.astype(np.int32)
        bad = rng.random(m) < 0.1
        rows[bad] = rng.choice(np.array([-1, n, n + 5, SENTINEL], np.int32),
                               bad.sum())
        return rows

    results = {}

    def same_resolve(a, b):
        return torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])

    # -- K1 resolve_dense: the steady tick's game-emit resolve --------------
    dense = np.full(dense_n, -1, np.int32)
    dense[:GAMES] = np.arange(GAMES, dtype=np.int32)
    dense_d = t(dense)
    out = resolve.resolve_dense(dense_d, games_d, valid_d)
    require(same_resolve(out, resolve.resolve_dense_plain(
        dense_d, games_d, valid_d)), "resolve_dense != plain (main path)")
    require(int(out[1]) == 0 and torch.equal(out[0], games_d),
            "resolve_dense: main-path lanes must all hit")
    dense_adv = dense.copy()
    dense_adv[rng.random(dense_n) < 0.2] = -1
    keys_adv, valid_adv = adversarial_keys(dense_n)
    dense_adv_d = t(dense_adv)
    require(same_resolve(
        resolve.resolve_dense(dense_adv_d, keys_adv, valid_adv),
        resolve.resolve_dense_plain(dense_adv_d, keys_adv, valid_adv)),
        "resolve_dense != plain (adversarial)")
    results["resolve_dense"] = dict(
        max_abs_err=0,
        library="torch.index_select (rows only, no miss count)",
        bound=bound(m * (4 + 1 + 4) + dense_n * 4 + 4),
        **measure(timer,
                  lambda: resolve.resolve_dense(dense_d, games_d, valid_d),
                  lambda: resolve.resolve_dense_plain(dense_d, games_d,
                                                      valid_d),
                  lambda: torch.index_select(dense_d, 0, games_d)))
    # the unfused tick's call takes a fresh miss counter from a zeroed pool
    # (part of ms); a fused window adds into its one total: the kernel
    # alone, and the zero fill a counter of its own would cost
    total_d = torch.zeros(1, dtype=torch.int32, device=dev)
    results["resolve_dense"]["fill_ms"] = timer(
        lambda: torch.zeros((), dtype=torch.int32, device=dev))
    results["resolve_dense"]["kernel_ms"] = timer(
        lambda: resolve.resolve_dense(dense_d, games_d, valid_d, total_d))

    # -- K2 resolve_sorted: the cold tick's resolve -------------------------
    skeys = np.concatenate([np.arange(GAMES, dtype=np.int32),
                            np.full(cap_g - GAMES, SENTINEL, np.int32)])
    srows = np.concatenate([np.arange(GAMES, dtype=np.int32),
                            np.full(cap_g - GAMES, -1, np.int32)])
    skeys_d, srows_d = t(skeys), t(srows)
    empty_d = torch.full((cap_g,), SENTINEL, dtype=torch.int32, device=dev)
    norows_d = torch.full((cap_g,), -1, dtype=torch.int32, device=dev)
    for sk, sr, keys, valid, what in (
            (skeys_d, srows_d, games_d, valid_d, "populated index"),
            (empty_d, norows_d, games_d, valid_d, "empty arena (cold tick)"),
            (skeys_d, srows_d, *adversarial_keys(2 * GAMES), "adversarial")):
        require(same_resolve(
            resolve.resolve_sorted(sk, sr, keys, valid),
            resolve.resolve_sorted_plain(sk, sr, keys, valid)),
            f"resolve_sorted != plain ({what})")
    cold = resolve.resolve_sorted(empty_d, norows_d, games_d, valid_d)
    require(int(cold[1]) == m, "resolve_sorted: empty arena must miss all")

    def sorted_bound(n_sorted, lanes):
        steps = math.ceil(math.log2(n_sorted + 1))
        return bound(lanes * (4 + 1 + 4) + 2 * n_sorted * 4 + 4,
                     int_ops=lanes * steps * 2)

    results["resolve_sorted"] = dict(
        max_abs_err=0,
        library="torch.searchsorted (search only)",
        bound=sorted_bound(cap_g, m),
        **measure(timer,
                  lambda: resolve.resolve_sorted(skeys_d, srows_d, games_d,
                                                 valid_d),
                  lambda: resolve.resolve_sorted_plain(skeys_d, srows_d,
                                                       games_d, valid_d),
                  lambda: torch.searchsorted(skeys_d, games_d)))
    # the second mirror size: 524,288 random keys (the routing sweep's sink
    # count), 1,048,576 lanes, nine in ten on a live key
    n_big, m_big = 524_288, 1 << 20
    big = np.sort(rng.choice(1 << 30, n_big, replace=False)).astype(np.int32)
    big_d, big_rows_d = t(big), t(rng.permutation(n_big).astype(np.int32))
    lanes_d = t(np.where(rng.random(m_big) < 0.9,
                         big[rng.integers(0, n_big, m_big)],
                         rng.integers(0, 1 << 30, m_big)).astype(np.int32))
    big_valid_d = t(rng.random(m_big) < 0.95)
    require(same_resolve(
        resolve.resolve_sorted(big_d, big_rows_d, lanes_d, big_valid_d),
        resolve.resolve_sorted_plain(big_d, big_rows_d, lanes_d,
                                     big_valid_d)),
        "resolve_sorted != plain (524,288-entry mirror)")
    results["resolve_sorted"]["variants"] = [dict(
        name=f"{n_big} random keys, {m_big} lanes",
        bound_ms=sorted_bound(n_big, m_big)[0],
        **measure(timer,
                  lambda: resolve.resolve_sorted(big_d, big_rows_d, lanes_d,
                                                 big_valid_d),
                  lambda: resolve.resolve_sorted_plain(
                      big_d, big_rows_d, lanes_d, big_valid_d),
                  lambda: torch.searchsorted(big_d, lanes_d)))]

    # -- K3 row_scatter: every op and dtype ----------------------------------
    variants = []
    totals = dict(ms=0.0, host_ms=0.0, plain_ms=0.0, library_ms=0.0,
                  bound_ms=0.0)
    max_err = 0.0
    ones_d = torch.ones(m, dtype=torch.int32, device=dev)
    tick = 7
    tick_full_d = torch.full((m,), tick, dtype=torch.int32, device=dev)
    tick_0d = torch.tensor(tick, dtype=torch.int32, device=dev)
    fvals_d = t(rng.standard_normal(m).astype(np.float32))
    sink_rows_d = t(np.random.default_rng(20260806).integers(
        0, HOT_SINKS, HOT_SOURCES).astype(np.int32))
    sink_rows64_d = sink_rows_d.long()
    hot_rows_d = torch.full((HOT_SOURCES,), 3, dtype=torch.int32, device=dev)
    hot_rows64_d = hot_rows_d.long()
    hot_tick_d = torch.full((HOT_SOURCES,), tick, dtype=torch.int32,
                            device=dev)
    # (name, op, column factory, rows, values, library call,
    #  bytes, on the steady tick's path)
    cases = [
        ("set i32 game", "set", lambda: torch.full((cap_p,), -1,
         dtype=torch.int32, device=dev), prow_d, games_d,
         lambda c: c.index_put_((prow64_d,), games_d), m * 12, True),
        ("set i32 tick (scalar)", "set", lambda: torch.zeros(
         cap_p, dtype=torch.int32, device=dev), prow_d, np.int32(tick),
         lambda c: c.index_put_((prow64_d,), tick_0d), m * 8, True),
        # the fused window's form: the tick read through a device pointer
        ("set i32 tick (device scalar, fused window)", "set",
         lambda: torch.zeros(cap_p, dtype=torch.int32, device=dev), prow_d,
         tick_0d, lambda c: c.index_put_((prow64_d,), tick_0d), m * 8 + 4,
         False),
        ("add i32 heartbeats", "add", lambda: torch.zeros(
         cap_p, dtype=torch.int32, device=dev), prow_d, ones_d,
         lambda c: c.index_add_(0, prow_d, ones_d), m * 16, True),
        ("max i32 touch players (scalar)", "max", lambda: torch.zeros(
         cap_p, dtype=torch.int32, device=dev), prow_d, tick,
         lambda c: c.scatter_reduce_(0, prow64_d, tick_full_d, "amax"),
         m * 12, True),
        ("max i32 touch games (scalar)", "max", lambda: torch.zeros(
         cap_g, dtype=torch.int32, device=dev), grow_d, tick,
         lambda c: c.scatter_reduce_(0, grow64_d, tick_full_d, "amax"),
         m * 4 + GAMES * 8, True),
        ("set f32", "set", lambda: torch.zeros(
         cap_p, dtype=torch.float32, device=dev), prow_d, fvals_d,
         lambda c: c.index_put_((prow64_d,), fvals_d), m * 12, False),
        ("add f32", "add", lambda: torch.zeros(
         cap_g, dtype=torch.float32, device=dev), grow_d, scores_d,
         lambda c: c.index_add_(0, grow_d, scores_d), m * 8 + GAMES * 8,
         False),
        ("max f32", "max", lambda: torch.full((cap_g,), float("-inf"),
         dtype=torch.float32, device=dev), grow_d, fvals_d,
         lambda c: c.scatter_reduce_(0, grow64_d, fvals_d, "amax"),
         m * 8 + GAMES * 8, False),
        # the routing sample's touch of its sinks: 1,048,576 lanes on the
        # sink arena's 1,024 rows, uniform over the 256 live ones, and its
        # hot sink, every lane on one row
        ("max i32 touch sinks (scalar)", "max", lambda: torch.zeros(
         SINK_ROWS, dtype=torch.int32, device=dev), sink_rows_d, tick,
         lambda c: c.scatter_reduce_(0, sink_rows64_d, hot_tick_d, "amax"),
         HOT_SOURCES * 4 + HOT_SINKS * 8, False),
        ("max i32 touch hot sink (scalar)", "max", lambda: torch.zeros(
         SINK_ROWS, dtype=torch.int32, device=dev), hot_rows_d, tick,
         lambda c: c.scatter_reduce_(0, hot_rows64_d, hot_tick_d, "amax"),
         HOT_SOURCES * 4 + 8, False),
    ]
    for name, op, make, rows_d, values, library, nbytes, on_path in cases:
        col = make()
        n = col.shape[0]
        dtype = col.dtype
        # the main path's inputs, then adversarial rows and values
        a = scatter.row_scatter(make(), rows_d, values, op)
        b = scatter.row_scatter_plain(make(), rows_d, values, op)
        adv = adversarial_rows(n, unique=(op == "set"))
        adv_d = t(adv)
        if isinstance(values, torch.Tensor) and values.dim() == 0:
            adv_vals = torch.tensor(-3, dtype=dtype, device=dev)
        elif isinstance(values, torch.Tensor):
            adv_vals = t(rng.standard_normal(m).astype(np.float32)) \
                if dtype == torch.float32 else \
                t(rng.integers(-999, 999, m).astype(np.int32))
        else:
            adv_vals = values
        base = t(rng.integers(-50, 50, n).astype(np.int32)).to(dtype)
        c = scatter.row_scatter(base.clone(), adv_d, adv_vals, op)
        d = scatter.row_scatter_plain(base.clone(), adv_d, adv_vals, op)
        err = 0.0
        for x, y, lanes, rws, start in ((a, b, values, rows_d, None),
                                        (c, d, adv_vals, adv_d, base)):
            if op == "add" and dtype == torch.float32:
                diff = (x - y).abs().cpu().numpy()
                lane_vals = lanes.cpu().numpy() \
                    if isinstance(lanes, torch.Tensor) \
                    else np.full(len(rws), lanes, np.float32)
                tol = _fan_in_tol(lane_vals, rws.cpu().numpy(), n,
                                  None if start is None
                                  else start.cpu().numpy())
                require(bool(np.all(diff <= tol)),
                        f"row_scatter {name} beyond tolerance")
                err = max(err, float(diff.max()))
            else:
                require(torch.equal(x, y), f"row_scatter {name} != plain")
        max_err = max(max_err, err)
        times = measure(
            timer, lambda: scatter.row_scatter(col, rows_d, values, op),
            lambda: scatter.row_scatter_plain(col, rows_d, values, op),
            lambda: library(col))
        times["bound_ms"] = bound(nbytes)[0]
        plan = scatter.scatter_plan(rows_d.shape[0], n, 1, op,
                                    not isinstance(values, torch.Tensor)
                                    or values.dim() == 0)
        variants.append(dict(
            name=name, on_steady_tick=on_path, max_abs_err=err,
            path="direct" if plan.cluster == 0
            else f"privatized, clusters of {plan.cluster}", **times))
        if on_path:
            for key in totals:
                totals[key] += times[key]
    results["row_scatter"] = dict(
        max_abs_err=max_err, ms=totals["ms"], host_ms=totals["host_ms"],
        plain_ms=totals["plain_ms"], library_ms=totals["library_ms"],
        library="index_put_ / index_add_ / scatter_reduce_",
        bound=(totals["bound_ms"], "bytes"),
        per="sum of the 5 launches of one steady tick", variants=variants)

    # -- K4 seg_sum: the game fan-in, and the routing sample's sinks -------
    # every path, forced, on each shape: the wrapper's own choice, direct
    # atomics, every block flushing alone, clusters of 2 and of 8
    def seg_forced(cluster, n_rows):
        chunk = -(-n_rows // max(cluster, 1))
        return segment.SegPlan(cluster, -(-chunk // 4) * 4 if cluster else 0,
                               *(segment.SEG_DIRECT if cluster == 0
                                 else segment.SEG_PRIVATE))

    def seg_check(vals_d, rows_d, n_rows, what):
        err = 0.0
        planned = segment.seg_plan(rows_d.shape[0], n_rows, 1, vals_d.dtype)
        b = segment.seg_sum_plain(vals_d, rows_d, n_rows)
        for plan in (None, *(seg_forced(c, n_rows) for c in (0, 1, 2, 8))):
            if plan is None:
                a = segment.seg_sum(vals_d, rows_d, n_rows)
            else:
                a = torch.zeros_like(b)
                segment.launch(vals_d, rows_d, a, plan)
            if vals_d.dtype == torch.int32:
                require(torch.equal(a, b), f"seg_sum i32 != plain ({what}, "
                        f"{plan or planned})")
            else:
                diff = (a - b).abs().cpu().numpy()
                tol = _fan_in_tol(vals_d.cpu().numpy(), rows_d.cpu().numpy(),
                                  n_rows)
                require(bool(np.all(diff <= tol)), f"seg_sum f32 beyond "
                        f"tolerance ({what}, {plan or planned})")
                err = max(err, float(diff.max()))
        return err, planned

    def seg_path(plan):
        return "direct" if plan.cluster == 0 else \
            f"privatized, clusters of {plan.cluster}"

    seg_ms = dict(ms=0.0, host_ms=0.0, plain_ms=0.0, library_ms=0.0,
                  fill_ms=0.0)
    seg_bound = 0.0
    seg_err = 0.0
    seg_variants = []
    adv_rows_d = t(adversarial_rows(cap_g, unique=False))
    for vals_d in (scores_d, ones_d):
        for rows_d, what in ((grow_d, "games"), (adv_rows_d, "adversarial")):
            err, planned = seg_check(vals_d, rows_d, cap_g, what)
            seg_err = max(seg_err, err)
        out = torch.zeros(cap_g, dtype=vals_d.dtype, device=dev)
        times = measure(
            timer, lambda: segment.seg_sum(vals_d, grow_d, cap_g),
            lambda: segment.seg_sum_plain(vals_d, grow_d, cap_g),
            lambda: out.index_add_(0, grow_d, vals_d))
        # the wrapper's zero fill alone (part of ms)
        times["fill_ms"] = timer(lambda: torch.zeros(
            cap_g, dtype=vals_d.dtype, device=dev))
        for key in seg_ms:
            seg_ms[key] += times[key]
        seg_bound += bound(m * 8 + cap_g * 4)[0]
    # the routing sample's shapes: 1,048,576 lanes on the sink arena's
    # 1,024 rows, uniform over 256 sinks and all on one hot sink
    srng = np.random.default_rng(20260806)
    sink_vals_d = t(srng.integers(1, 8, HOT_SOURCES).astype(np.float32))
    for name, rows_d in (
            ("256 sinks, float32", t(srng.integers(
                0, HOT_SINKS, HOT_SOURCES).astype(np.int32))),
            ("one hot sink, float32", torch.full(
                (HOT_SOURCES,), 3, dtype=torch.int32, device=dev))):
        err, planned = seg_check(sink_vals_d, rows_d, SINK_ROWS, name)
        seg_err = max(seg_err, err)
        sink_out = torch.zeros(SINK_ROWS, device=dev)
        times = measure(
            timer, lambda: segment.seg_sum(sink_vals_d, rows_d, SINK_ROWS),
            lambda: segment.seg_sum_plain(sink_vals_d, rows_d, SINK_ROWS),
            lambda: sink_out.index_add_(0, rows_d, sink_vals_d))
        seg_variants.append(dict(
            name=f"{name}: {HOT_SOURCES} lanes, {SINK_ROWS} rows",
            path=seg_path(planned), max_abs_err=err,
            bound_ms=bound(HOT_SOURCES * 8 + SINK_ROWS * 4)[0], **times))
    results["seg_sum"] = dict(
        max_abs_err=seg_err, library="index_add_ (into a zeroed tensor "
        "allocated beforehand; the wrapper's time includes its fill)",
        bound=(seg_bound, "bytes"), **seg_ms,
        path=seg_path(segment.seg_plan(m, cap_g, 1, torch.float32)),
        per="sum of the 2 launches of one steady tick, their zero fills "
            "included (fill_ms: the fills alone)", variants=seg_variants)

    # -- seg_max (K3 MAX into a -inf column) and seg_mean (K4 twice) -------
    from orleans_tpu_torch.tensor.vector_grain import seg_max, seg_mean

    ref_max = torch.full((cap_g,), float("-inf"), device=dev)
    require(torch.equal(seg_max(scores_d, grow_d, cap_g),
                        ref_max.scatter_reduce(0, grow64_d, scores_d,
                                               "amax")), "seg_max")
    mean_ref = segment.seg_sum_plain(scores_d, grow_d, cap_g) / torch.clamp(
        segment.seg_sum_plain(torch.ones_like(scores_d), grow_d, cap_g),
        min=1)
    mean_diff = (seg_mean(scores_d, grow_d, cap_g) - mean_ref).abs()
    mean_tol = torch.from_numpy(_fan_in_tol(
        scores, games, cap_g)).to(dev) / torch.clamp(
        torch.bincount(grow64_d, minlength=cap_g), min=1) \
        + 2.0**-23 * mean_ref.abs()
    require(bool((mean_diff <= mean_tol).all()), "seg_mean beyond tolerance")
    ones_f = torch.ones_like(scores_d)
    for name, fn, plain, library in (
            ("seg_max", lambda: seg_max(scores_d, grow_d, cap_g),
             lambda: scatter.row_scatter_plain(
                 torch.full((cap_g,), float("-inf"), device=dev), grow_d,
                 scores_d, "max"),
             lambda: ref_max.scatter_reduce(0, grow64_d, scores_d, "amax")),
            ("seg_mean", lambda: seg_mean(scores_d, grow_d, cap_g),
             lambda: segment.seg_sum_plain(scores_d, grow_d, cap_g)
             / torch.clamp(segment.seg_sum_plain(ones_f, grow_d, cap_g),
                           min=1),
             lambda: torch.zeros(cap_g, device=dev).index_reduce_(
                 0, grow64_d, scores_d, "mean", include_self=False))):
        times = measure(timer, fn, plain, library)
        print(f"composite {name} (not on Presence's path): "
              f"{times['ms']:.4f} ms on the device, host "
              f"{times['host_ms']:.4f} (plain {times['plain_ms']:.4f}, "
              f"library {times['library_ms']:.4f}, bound "
              f"{bound(m * 8 + cap_g * 4)[0]:.4f} by bytes) on {card}",
              flush=True)

    # the fused window's bound: per tick the bytes of its kernels — K3 set
    # game, set tick (device scalar), add heartbeats; K1; K4 twice; K5
    # three times on a mask alone — times the 16 ticks of a window
    per_tick = bound(m * 12)[0] + bound(m * 8 + 4)[0] + bound(m * 16)[0] \
        + results["resolve_dense"]["bound"][0] + seg_bound \
        + 3 * bound(m + 4)[0]
    results["window_bound_ms"] = 16 * per_tick

    # -- K5 hist_count: the ledger's masked count ----------------------------
    hist_d = torch.zeros((64, 16), dtype=torch.int32, device=dev)
    base_adv = t(rng.random(m) < 0.7)
    rows_adv = t(adversarial_rows(cap_g, unique=False))
    for base, rows, what in ((valid_d, grow_d, "main path, rows"),
                             (valid_d, None, "in-window, no rows"),
                             (base_adv, rows_adv, "adversarial, rows"),
                             (base_adv, None, "adversarial, no rows")):
        h0 = t(rng.integers(0, 99, (64, 16)).astype(np.int32))
        a = hist.hist_count(h0.clone(), 9, 4, base, rows)
        b = hist.hist_count_plain(h0.clone(), 9, 4, base, rows)
        require(torch.equal(a, b), f"hist_count != plain ({what})")
    require(int(hist.hist_count(torch.zeros_like(hist_d), 1, 0, valid_d,
                                grow_d)[1, 0]) == m,
            "hist_count: main-path lanes must all count")
    cell = torch.tensor([9 * 16 + 4], dtype=torch.int64, device=dev)
    flat = hist_d.view(-1)

    def library_count():
        flat.index_add_(0, cell, ((grow_d >= 0) & valid_d).sum(
            dtype=torch.int32).view(1))

    results["hist_count"] = dict(
        max_abs_err=0,
        library="torch.sum + index_add_ (two calls)",
        bound=bound(m * (1 + 4) + 4),
        per="one launch: a batch's rows and mask (the in-window form "
            "reads the mask alone)",
        **measure(timer,
                  lambda: hist.hist_count(hist_d, 9, 4, valid_d, grow_d),
                  lambda: hist.hist_count_plain(hist_d, 9, 4, valid_d,
                                                grow_d),
                  library_count))

    # -- K5 hist_count_many: a fused tick's counts in one launch of K5 -------
    # the Presence tick's three (the heartbeats' and the game updates'
    # applied lanes into the ledger, the emit's delivered lanes into the
    # totals), then 1 to 8 counts with an empty one, lengths below a
    # 16-lane group, bases at odd offsets and rows off their alignment
    totals_d = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    emask_d = grow_d >= 0
    tick = [(hist_d, 9, 0, valid_d, None), (totals_d, 0, 1, emask_d, None),
            (hist_d, 3, 0, emask_d, None)]
    odd = [(hist_d, k, k % 16, base_adv[k:k + n], rows_adv[1:1 + n]
            if k % 2 else None)
           for k, n in enumerate((m - 9, 0, 5, 16, 17, 1, 4099, 70_001))]
    for entries, what in ((tick, "the Presence tick"),
                          (odd, "eight odd counts"), (odd[:1], "one")):
        h0 = t(rng.integers(0, 99, (64, 16)).astype(np.int32))
        t0 = t(rng.integers(0, 99, (1, 2)).astype(np.int32))
        ha, ta, hb, tb = h0.clone(), t0.clone(), h0.clone(), t0.clone()
        hist.hist_count_many([(ha if h is hist_d else ta, *e)
                              for h, *e in entries])
        hist.hist_count_many_plain([(hb if h is hist_d else tb, *e)
                                    for h, *e in entries])
        require(torch.equal(ha, hb) and torch.equal(ta, tb),
                f"hist_count_many != plain ({what})")

    tick_cells = [torch.tensor([s_ * h.shape[1] + b_], device=dev)
                  for h, s_, b_, _m, _r in tick]

    def library_tick():
        for (h, _s, _b, mk, _r), c in zip(tick, tick_cells):
            h.view(-1).index_add_(0, c, mk.sum(dtype=torch.int32).view(1))

    tick_ms = measure(timer, lambda: hist.hist_count_many(tick),
                      lambda: hist.hist_count_many_plain(tick), library_tick)
    results["hist_count"]["variants"] = [dict(
        name="fused_tick", max_abs_err=0,
        per="hist_count_many, one launch: a fused Presence tick's three "
            f"counts (masks of {m} lanes); library: torch.sum + index_add_ "
            "per count",
        ms=tick_ms["ms"], host_ms=tick_ms["host_ms"],
        plain_ms=tick_ms["plain_ms"], library_ms=tick_ms["library_ms"],
        bound_ms=bound(m + 2 * m + 12)[0],
        singles_ms=timer(lambda: [hist.hist_count(*e) for e in tick]))]

    # -- K6 miss_keys: the cold drain and the cluster inject ------------------
    cold_rows = torch.full((m,), -1, dtype=torch.int32, device=dev)
    # a 2-silo cluster's inject: the remote silo's games (the odd ones) miss
    cluster_rows = t(np.where(games % 2 == 1, -1, games).astype(np.int32))
    many = t(rng.permutation(8 * m)[:m].astype(np.int32))  # > MISS_BUF
    dup = torch.full((m,), 41, dtype=torch.int32, device=dev)
    odd_keys, odd_valid = adversarial_keys(4 * GAMES)
    odd_rows = t(np.where(rng.random(m) < 0.5, -1, 3).astype(np.int32))
    for keys, rows, valid, what in (
            (games_d, cold_rows, valid_d, "cold tick (main path)"),
            (games_d, cluster_rows, valid_d, "cluster inject"),
            (many, cold_rows, valid_d, f"{m} unique misses > {MISS_BUF}"),
            (dup, odd_rows, valid_d, "all-duplicate keys"),
            (odd_keys, odd_rows, odd_valid, "sentinel/negative/hit lanes")):
        for miss_buf in (MISS_BUF, 1000):
            a = miss.miss_keys(keys, rows, valid, miss_buf)
            b = miss.miss_keys_plain(keys, rows, valid, miss_buf)
            require(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                    f"miss_keys != plain ({what}, miss_buf {miss_buf})")

    def k6_times(rows):
        return measure(
            timer, lambda: miss.miss_keys(games_d, rows, valid_d, MISS_BUF),
            lambda: miss.miss_keys_plain(games_d, rows, valid_d, MISS_BUF),
            lambda: torch.unique(torch.where((rows < 0) & valid_d, games_d,
                                             SENTINEL), sorted=True))

    k6_bound = bound(m * (4 + 4 + 1) + m + MISS_BUF * 4)
    results["miss_keys"] = dict(
        max_abs_err=0,
        library="torch.unique (sorted) of the masked keys",
        bound=k6_bound,
        per="one launch of the chain (three kernels: the mark with warp "
            "leaders over a pooled table, a cooperative sort whose path the "
            "count of unique keys chooses on the device, the emit that "
            "clears the table's used slots), at the cold tick",
        **k6_times(cold_rows))
    cluster_ms = k6_times(cluster_rows)
    results["miss_keys"]["variants"] = [dict(
        name="cluster_inject", max_abs_err=0,
        per=f"{m} lanes over {GAMES} games, the remote silo's half missing "
            f"({int((games % 2 == 1).sum())} lanes)",
        bound_ms=k6_bound[0], **cluster_ms)]

    for name, r in results.items():
        if not isinstance(r, dict):
            continue
        print(f"kernel {name}: {r['ms']:.4f} ms on the device, "
              f"{r['host_ms']:.4f} ms host enqueue "
              f"(plain {r['plain_ms']:.4f}, "
              f"library {r['library_ms']:.4f} [{r['library']}], bound "
              f"{r['bound'][0]:.4f} by {r['bound'][1]}) max_abs_err "
              f"{r['max_abs_err']:.3g} on {card}", flush=True)
        if "kernel_ms" in r:
            print(f"  {name}: the kernel alone, into a given counter, "
                  f"{r['kernel_ms']:.4f} ms; a counter's zero fill alone "
                  f"{r['fill_ms']:.4f}", flush=True)
        elif "fill_ms" in r:
            print(f"  {name}: its zero fills {r['fill_ms']:.4f} ms of it; "
                  f"path {r['path']}", flush=True)
        print_variants(name, r, card)
    return results


def print_variants(name: str, r: dict, card: str) -> None:
    """A kernel's variants, one line each, and where the kernel was
    redesigned, its previous time (``PREVIOUS_MS``) beside this run's at
    each shape."""
    if (name, None) in PREVIOUS_MS:
        print(f"  {name}: previous kernel {PREVIOUS_MS[name, None]:.4f} ms "
              f"-> {r['ms']:.4f} ms on {card}", flush=True)
    for v in r.get("variants", []):
        previous = PREVIOUS_MS.get((name, v["name"]))
        print(f"  {name} {v['name']}: {v['ms']:.4f} ms, host "
              f"{v['host_ms']:.4f} (plain "
              f"{v['plain_ms']:.4f}, library {v['library_ms']:.4f}, "
              f"bound {v['bound_ms']:.4f})"
              + (f" path {v['path']}" if "path" in v else "")
              + (f"; previous kernel {previous:.4f} ms"
                 if previous is not None else ""),
              flush=True)


# ---------------------------------------------------------------------------
# phase 3b: the attribution kernels (K7, K8, K9) against their plain versions
# ---------------------------------------------------------------------------

def np_cms_hash(rows: np.ndarray, seeds, width: int) -> np.ndarray:
    """The sketch buckets of non-negative ``rows`` in numpy uint32, which
    wraps mod 2**32 (the oracle's own copy of the hash)."""
    u0 = rows.astype(np.uint32)
    out = []
    for seed in seeds:
        u = u0 * np.uint32(seed)
        u ^= u >> np.uint32(15)
        u = u * np.uint32(0x27D4EB2F)
        u ^= u >> np.uint32(13)
        out.append((u & np.uint32(width - 1)).astype(np.int64))
    return np.stack(out)


def check_attr_kernels(dev, timer, card: str) -> dict:
    """K7 ``attr_fold`` in its four modes (and gated), K8 ``attr_apply``
    (host k and device k) and ``attr_match`` (entries that match and
    entries that do not), K9 ``attr_snapshot`` (the main path's columns
    and adversarial ones), each against its plain version on the card at
    the shapes of Presence 1M/10k: PresenceGrain 2,097,152 rows,
    GameGrain 32,768, 1,048,576 lanes, a 4x8192 sketch, 64 slots.
    Integers must match exactly; K9's float32 Gini within a relative
    2**-20 (the kernel and the plain version sum its float64 terms in
    different orders), its mean exactly."""
    from orleans_tpu_torch.kernels import attr
    from orleans_tpu_torch.samples.presence import presence_inputs
    from orleans_tpu_torch.tensor.attribution import CMS_SEEDS

    seeds = CMS_SEEDS[:4]
    depth, width = 4, 8192
    cap_p, cap_g = 1 << 21, 1 << 15
    m = PLAYERS
    _, games, _ = presence_inputs(PLAYERS, GAMES, seed=0)
    rng = np.random.default_rng(4321)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    def base(*shape):
        return t(rng.integers(0, 50, shape).astype(np.int32))

    prow = torch.arange(m, dtype=torch.int32, device=dev)
    grow = t(games)
    valid = torch.ones(m, dtype=torch.bool, device=dev)
    adv = rng.integers(-5, cap_g + 50, m).astype(np.int32)
    odd = rng.random(m)
    adv[odd < 0.01] = -2**31
    adv[(odd >= 0.01) & (odd < 0.02)] = 2**31 - 1
    adv_rows, adv_valid = t(adv), t(rng.random(m) < 0.8)
    touched_p, touched_g = m, int(np.count_nonzero(np.bincount(games)))
    g_counts = np.bincount(games, minlength=cap_g).astype(np.int32)

    def buckets(weights_rows: np.ndarray) -> int:
        """Distinct sketch buckets the given rows touch, over the depths."""
        h = np_cms_hash(weights_rows, seeds, width)
        return sum(len(np.unique(h[d])) for d in range(depth))

    b_p = buckets(np.arange(m))
    b_g = buckets(np.nonzero(g_counts)[0])

    def fold_check(name, counts, cms, rows=None, valid_=None, **kw):
        """K7 and its plain version on clones of the same accumulators."""
        outs = []
        for fn in (attr.attr_fold, attr.attr_fold_plain):
            c = counts.clone() if counts is not None else None
            s = cms.clone() if cms is not None else None
            kwc = {k: v.clone() if k in ("total", "stale") else v
                   for k, v in kw.items()}
            fn(c, s, seeds, rows, valid_, **kwc)
            outs.append([x for x in (c, s, kwc.get("total"),
                                     kwc.get("stale")) if x is not None])
        for x, y in zip(*outs):
            require(torch.equal(x, y), f"attr_fold != plain ({name})")

    slots = base(64)
    w_p = torch.zeros(cap_p, dtype=torch.int32, device=dev)
    w_p[:m] = 16
    w_g = t(16 * g_counts)
    shut = torch.zeros(1, dtype=torch.int32, device=dev)
    open_ = torch.ones(1, dtype=torch.int32, device=dev)
    stale = torch.zeros(1, dtype=torch.int32, device=dev)
    # (name, counts, cms, rows, valid, kwargs, bytes, library, on the
    # fused tick's path)
    fold_cases = [
        ("plan, PresenceGrain (a novel batch's delta plan)", zeros(cap_p),
         zeros(depth, width), prow, valid, dict(total=zeros(1)),
         5 * m + 8 * touched_p + 8 * b_p + 8, None, False),
        ("full fold, GameGrain (a mismatched checked entry)", base(cap_g),
         base(depth, width), grow, valid, dict(total=slots, slot=1),
         5 * m + 8 * touched_g + 8 * b_g + 8, None, False),
        ("counts only, PresenceGrain delta (every fused tick)", zeros(cap_p),
         None, prow, valid, dict(total=slots, slot=0),
         5 * m + 8 * touched_p + 8, "p", True),
        ("counts only, GameGrain delta (every fused tick)", zeros(cap_g),
         None, grow, valid, dict(total=slots, slot=1),
         5 * m + 8 * touched_g + 8, "g", True),
        ("weighted, PresenceGrain (once per window)", base(cap_p),
         base(depth, width), None, None, dict(weight=w_p),
         4 * cap_p + 8 * touched_p + 8 * b_p, "wp", False),
        ("weighted, GameGrain (once per window)", base(cap_g),
         base(depth, width), None, None, dict(weight=w_g),
         4 * cap_g + 8 * touched_g + 8 * b_g, "wg", False),
    ]
    for name, counts, cms, rows, valid_, kw, *_ in fold_cases:
        fold_check(name, counts, cms, rows, valid_, **kw)
    fold_check("adversarial lanes", base(cap_g), base(depth, width),
               adv_rows, adv_valid, total=slots, slot=5)
    fold_check("gate shut", base(cap_g), base(depth, width), grow, valid,
               total=slots, slot=1, gate=shut, stale=stale)
    fold_check("gate open", base(cap_g), base(depth, width), grow, valid,
               total=slots, slot=1, gate=open_, stale=stale)
    ones = torch.ones(m, dtype=torch.int32, device=dev)
    library_of = {
        "p": lambda c: c.index_add_(0, prow, ones),
        "g": lambda c: c.index_add_(0, grow, ones),
        "wp": lambda c: c.add_(w_p), "wg": lambda c: c.add_(w_g)}
    variants = []
    fold_sum = dict(ms=0.0, host_ms=0.0, plain_ms=0.0, library_ms=0.0,
                    bound_ms=0.0)
    for name, counts, cms, rows, valid_, kw, nbytes, lib, on_tick \
            in fold_cases:
        lib_fn = library_of.get(lib)
        times = measure(
            timer,
            lambda: attr.attr_fold(counts, cms, seeds, rows, valid_, **kw),
            lambda: attr.attr_fold_plain(counts, cms, seeds, rows, valid_,
                                         **kw),
            (lambda: lib_fn(counts)) if lib_fn is not None else None)
        # per lane or row: the hash's ~12 integer operations per depth
        times["bound_ms"] = bound(
            nbytes, int_ops=(m if rows is not None else counts.shape[0])
            * (12 * depth if cms is not None else 2))[0]
        plan = attr.fold_plan(
            (kw["weight"] if rows is None else rows).shape[0],
            counts.shape[0], *(cms.shape if cms is not None else (0, 1)),
            rows is None)
        variants.append(dict(name=name, on_fused_tick=on_tick,
                             path=f"cluster of {plan.cluster}"
                             if plan.cluster else "direct", **times))
        if on_tick:
            for key in fold_sum:
                fold_sum[key] += times[key]
    results = {"attr_fold": dict(
        max_abs_err=0, ms=fold_sum["ms"], host_ms=fold_sum["host_ms"],
        plain_ms=fold_sum["plain_ms"], library_ms=fold_sum["library_ms"],
        library="index_add_ of the lanes into the counts (no sketch, no "
                "slot)", bound=(fold_sum["bound_ms"], "bytes"),
        per="sum of the 2 launches of one fused tick (counts only)",
        variants=variants)}

    # -- K8 attr_apply: the flush of 16 host-proven heartbeat folds --------
    cdelta_p, sdelta_p, n_p = zeros(cap_p), zeros(depth, width), zeros(1)
    attr.attr_fold(cdelta_p, sdelta_p, seeds, prow, valid, total=n_p)
    sdelta_g, n_g = zeros(depth, width), zeros(1)
    cdelta_g = zeros(cap_g)
    attr.attr_fold(cdelta_g, sdelta_g, seeds, grow, valid, total=n_g)
    k_dev = torch.tensor([13], dtype=torch.int32, device=dev)
    for name, cnt, cd, cms, sd, k, n in (
            ("PresenceGrain, k = 16 on the host", base(cap_p), cdelta_p,
             base(depth, width), sdelta_p, 16, n_p),
            ("GameGrain, k read on the device", base(cap_g), cdelta_g,
             base(depth, width), sdelta_g, k_dev, n_g)):
        a = [cnt.clone(), cms.clone(), slots.clone()]
        b = [cnt.clone(), cms.clone(), slots.clone()]
        attr.attr_apply(a[0], cd, a[1], sd, k, total=a[2], slot=3, n=n)
        attr.attr_apply_plain(b[0], cd, b[1], sd, k, total=b[2], slot=3, n=n)
        require(all(torch.equal(x, y) for x, y in zip(a, b)),
                f"attr_apply != plain ({name})")
    # the PresenceGrain flush on views 1 and 3 words past a 16-byte line
    # and a word short of their length (a head, a tail, odd lengths), and
    # with the counts and the delta on different lines (word by word)
    def shifted(x, off, n_words):
        flat = torch.empty(n_words + 8, dtype=x.dtype, device=dev)
        v = flat[off:off + n_words]
        v.copy_(x.reshape(-1)[:n_words])
        return v

    n_c, n_s = cap_p - 1, depth * width - 1
    for acc_off, delta_off in ((1, 1), (3, 3), (1, 2)):
        cd = shifted(cdelta_p, delta_off, n_c)
        sd = shifted(sdelta_p, delta_off, n_s).view(1, -1)
        cnt, cms = base(n_c), base(1, n_s)
        a = [shifted(cnt, acc_off, n_c),
             shifted(cms, acc_off, n_s).view(1, -1), slots.clone()]
        b = [cnt.clone(), cms.clone(), slots.clone()]
        attr.attr_apply(a[0], cd, a[1], sd, 16, total=a[2], slot=3, n=n_p)
        attr.attr_apply_plain(b[0], cd, b[1], sd, 16, total=b[2], slot=3,
                              n=n_p)
        require(all(torch.equal(x, y) for x, y in zip(a, b)),
                f"attr_apply != plain (views at {acc_off} / {delta_off} "
                f"words)")
    counts_p, cms_p = base(cap_p), base(depth, width)
    nnz_sd = int((sdelta_p != 0).sum())
    counts_g, cms_g = base(cap_g), base(depth, width)
    nnz_sg = int((sdelta_g != 0).sum())
    k_alpha = int(k_dev[0])
    results["attr_apply"] = dict(
        max_abs_err=0, library="add_(cdelta, alpha=k) (the counts only)",
        bound=bound(4 * cap_p + 4 * depth * width + 8 * m + 8 * nnz_sd + 12),
        per="one launch: a flush of 16 folds of the PresenceGrain plan",
        **measure(timer,
                  lambda: attr.attr_apply(counts_p, cdelta_p, cms_p,
                                          sdelta_p, 16, total=slots, slot=3,
                                          n=n_p),
                  lambda: attr.attr_apply_plain(counts_p, cdelta_p, cms_p,
                                                sdelta_p, 16, total=slots,
                                                slot=3, n=n_p),
                  lambda: counts_p.add_(cdelta_p, alpha=16)))
    results["attr_apply"]["variants"] = [dict(
        name="GameGrain flush, k read on the device",
        bound_ms=bound(4 * cap_g + 4 * depth * width + 8 * touched_g
                       + 8 * nnz_sg + 16)[0],
        **measure(timer,
                  lambda: attr.attr_apply(counts_g, cdelta_g, cms_g,
                                          sdelta_g, k_dev, total=slots,
                                          slot=3, n=n_g),
                  lambda: attr.attr_apply_plain(counts_g, cdelta_g, cms_g,
                                                sdelta_g, k_dev, total=slots,
                                                slot=3, n=n_g),
                  lambda: counts_g.add_(cdelta_g, alpha=k_alpha)))]

    # -- K8 attr_match: 16 stacked GameGrain entries, two of them stale ----
    k = 16
    rows_l, valid_l = match_stacks(grow, valid, k)
    rows_l[3][12345] += 1
    valid_l[11][m - 1] = False
    outs = []
    for fn in (attr.attr_match, attr.attr_match_plain):
        flags = torch.full((k,), 7, dtype=torch.int32, device=dev)
        km = zeros(1)
        fn(rows_l, valid_l, grow, valid, flags, km)
        outs.append((flags.tolist(), int(km[0])))
    require(outs[0] == outs[1] and outs[0][1] == k - 2,
            f"attr_match != plain: {outs}")
    flags, km = zeros(k), zeros(1)
    results["attr_match"] = dict(
        max_abs_err=0, library=None,
        bound=bound((k + 1) * 5 * m + 4 * k + 4),
        per=f"one launch: {k} stacked GameGrain entries of {m} lanes",
        **measure(timer,
                  lambda: attr.attr_match(rows_l, valid_l, grow, valid,
                                          flags, km),
                  lambda: attr.attr_match_plain(rows_l, valid_l, grow,
                                                valid, flags, km), None))
    # 1 and 32 entries, every entry stale, and entries one word (rows) and
    # one byte (valid) past a 16-byte boundary, as rows of a longer buffer
    # are (the last entry differing in its last lane)
    match_variants = []
    for name, k_v in (("k1", 1), ("k32", 32), ("k16_all_stale", 16),
                      ("k1_odd_offset", 1), ("k16_odd_offset", 16),
                      ("k32_odd_offset", 32)):
        rows_v, valid_v = match_stacks(grow, valid, k_v,
                                       odd=name.endswith("odd_offset"))
        if name.endswith("odd_offset"):
            rows_v[k_v - 1][m - 1] += 1
        elif name == "k16_all_stale":
            for e, r in enumerate(rows_v):
                r[(e * 65_537) % m] += 1
        outs = []
        for fn in (attr.attr_match, attr.attr_match_plain):
            flags_v = torch.full((k_v,), 7, dtype=torch.int32, device=dev)
            km_v = zeros(1)
            fn(rows_v, valid_v, grow, valid, flags_v, km_v)
            outs.append((flags_v.tolist(), int(km_v[0])))
        want_km = {"k1": 1, "k32": 32, "k16_all_stale": 0}.get(name, k_v - 1)
        require(outs[0] == outs[1] and outs[0][1] == want_km,
                f"attr_match != plain ({name}): {outs}")
        flags_v, km_v = zeros(k_v), zeros(1)
        match_variants.append(dict(
            name=name, max_abs_err=0,
            per=f"{k_v} entries of {m} lanes",
            bound_ms=bound((k_v + 1) * 5 * m + 4 * k_v + 4)[0],
            **measure(timer,
                      lambda a=(rows_v, valid_v, grow, valid, flags_v,
                                km_v): attr.attr_match(*a),
                      lambda a=(rows_v, valid_v, grow, valid, flags_v,
                                km_v): attr.attr_match_plain(*a), None)))
    results["attr_match"]["variants"] = match_variants

    # -- K9 attr_snapshot ----------------------------------------------------
    snap_p = torch.zeros(cap_p, dtype=torch.int32, device=dev)
    snap_p[:m] = 23
    snap_g = t(23 * g_counts)
    cms_s = base(depth, width)
    p = 1.0 / np.arange(1, cap_p + 1) ** 1.1
    zipf = np.bincount(np.searchsorted(np.cumsum(p / p.sum()),
                                       rng.random(4 * m)),
                       minlength=cap_p)[:cap_p].astype(np.int32)
    sparse = np.where(rng.random(cap_p) < 0.001,
                      rng.integers(1, 9, cap_p), 0).astype(np.int32)
    snap_err = 0.0
    for name, col, n_shards in (
            ("PresenceGrain (every row tied)", snap_p, 1),
            ("GameGrain", snap_g, 1),
            ("zipf, shuffled", t(rng.permutation(zipf)), 1),
            ("zipf, 4 shards", t(zipf), 4),
            ("sparse", t(sparse), 1),
            ("all zero", zeros(cap_p), 1)):
        got = attr.decode_snapshot(attr.attr_snapshot(
            col, cms_s, seeds, 16, n_shards).cpu().numpy(), 16, n_shards)
        want = attr.decode_snapshot(attr.attr_snapshot_plain(
            col, cms_s, seeds, 16, n_shards).cpu().numpy(), 16, n_shards)
        for key in ("vals", "rows", "est", "shard"):
            require(np.array_equal(got[key], want[key]),
                    f"attr_snapshot {key} != plain ({name})")
        for key in ("total", "nnz", "p99", "mean_nz"):
            require(got[key] == want[key],
                    f"attr_snapshot {key} != plain ({name})")
        err = abs(float(got["gini"]) - float(want["gini"]))
        require(err <= 2.0**-20 * max(abs(float(want["gini"])), 2.0**-10),
                f"attr_snapshot gini {got['gini']} vs {want['gini']} "
                f"({name})")
        snap_err = max(snap_err, err)
    require(attr.decode_snapshot(attr.attr_snapshot(
        snap_p, cms_s, seeds, 16).cpu().numpy(), 16, 1)["rows"].tolist()
        == list(range(16)), "attr_snapshot: ties must order by row")
    results["attr_snapshot"] = dict(
        max_abs_err=snap_err,
        library="torch.sort(descending=True, stable=True) of the counts "
                "(the order only)",
        bound=bound(4 * (cap_p + cap_g) + 2 * 8 * (3 * 16 + 6)),
        per="one snapshot: both arenas (PresenceGrain 2M rows, GameGrain "
            "32K)",
        **measure(timer,
                  lambda: (attr.attr_snapshot(snap_p, cms_s, seeds, 16),
                           attr.attr_snapshot(snap_g, cms_s, seeds, 16)),
                  lambda: (attr.attr_snapshot_plain(snap_p, cms_s, seeds,
                                                    16, 1),
                           attr.attr_snapshot_plain(snap_g, cms_s, seeds,
                                                    16, 1)),
                  lambda: (torch.sort(snap_p, descending=True, stable=True),
                           torch.sort(snap_g, descending=True,
                                      stable=True))))
    results["attr_window_bound_ms"] = 16 * sum(
        v["bound_ms"] for v in variants if v["on_fused_tick"]) + sum(
        v["bound_ms"] for v in variants if v["name"].startswith("weighted"))

    for name in ("attr_fold", "attr_apply", "attr_match", "attr_snapshot"):
        r = results[name]
        lib = "null" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} [{r['library']}]"
        print(f"kernel {name}: {r['ms']:.4f} ms on the device, "
              f"{r['host_ms']:.4f} ms host enqueue (plain "
              f"{r['plain_ms']:.4f}, library {lib}, bound "
              f"{r['bound'][0]:.4f} by {r['bound'][1]}) max_abs_err "
              f"{r['max_abs_err']:.3g}; {r['per']}; on {card}", flush=True)
    for v in variants:
        lib = "null" if v["library_ms"] is None else \
            f"{v['library_ms']:.4f}"
        print(f"  attr_fold {v['name']} [{v['path']}]: {v['ms']:.4f} ms, "
              f"host "
              f"{v['host_ms']:.4f} (plain {v['plain_ms']:.4f}, library "
              f"{lib}, bound {v['bound_ms']:.4f})", flush=True)
    for v in results["attr_apply"]["variants"]:
        print(f"  attr_apply {v['name']}: {v['ms']:.4f} ms, host "
              f"{v['host_ms']:.4f} (plain {v['plain_ms']:.4f}, library "
              f"{v['library_ms']:.4f}, bound {v['bound_ms']:.4f})",
              flush=True)
    for v in results["attr_match"]["variants"]:
        print(f"  attr_match {v['name']}: {v['ms']:.4f} ms, host "
              f"{v['host_ms']:.4f} (plain {v['plain_ms']:.4f}, library "
              f"null, bound {v['bound_ms']:.4f})", flush=True)
    return results


def time_plain_programs(dev, timer, card: str) -> None:
    """The two device programs the port keeps as plain PyTorch (no path
    runs ``accumulate``; ``_stack_counts`` gathers a drain's parked miss
    counters), timed beside their bounds at the main path's shapes."""
    from orleans_tpu_torch.tensor.engine import _stack_counts
    from orleans_tpu_torch.tensor.ledger import accumulate

    rng = np.random.default_rng(99)
    hist = torch.zeros((64, 16), dtype=torch.int32, device=dev)
    deltas = torch.from_numpy(rng.integers(0, 5000, PLAYERS).astype(
        np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(PLAYERS) < 0.9).to(dev)
    acc_ms = timer(lambda: accumulate(hist, 3, deltas, valid))
    # a log2 bucket per lane (~10 integer operations), a count per bucket
    acc_bound = bound(PLAYERS * (4 + 1) + 2 * 16 * 4, int_ops=PLAYERS * 10)
    counters = [torch.tensor(i, dtype=torch.int32, device=dev)
                for i in range(16)]
    stack_ms = timer(lambda: _stack_counts(*counters))
    stack_bound = bound(2 * 16 * 4)
    print(f"plain program accumulate (ledger.py, no caller): {acc_ms:.4f} ms "
          f"on the device for {PLAYERS} lanes (bound {acc_bound[0]:.4f} by "
          f"{acc_bound[1]}); _stack_counts of 16 parked counters: "
          f"{stack_ms:.4f} ms (bound {stack_bound[0]:.6f} by "
          f"{stack_bound[1]}); on {card}", flush=True)


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def game_updates(games, hb_ticks, switch=None) -> np.ndarray:
    """Updates per game key of the load (see ``check_presence``)."""
    per_game = np.bincount(games, minlength=COLD_GAME + 1) * hb_ticks
    if switch is not None:
        p, g, n = switch
        per_game[games[p]] -= n
        per_game[g] += n
    return per_game


def check_presence(engine, games, scores, hb_ticks, last_tick, want_msgs,
                   switch=None) -> None:
    """Every column of both arenas against the numpy oracle of the load:
    ``hb_ticks`` heartbeats per player, the last one carrying
    ``last_tick``; ``switch = (player, game, ticks)`` moves one player to
    another game for its last ``ticks`` heartbeats."""
    players = np.arange(PLAYERS, dtype=np.int64)
    require(engine.messages_processed == want_msgs,
            f"messages_processed {engine.messages_processed} != {want_msgs}")
    final_games = games.copy()
    per_game = game_updates(games, hb_ticks, switch)
    score_sum = np.bincount(games, weights=scores.astype(np.float64),
                            minlength=COLD_GAME + 1) * hb_ticks
    if switch is not None:
        p, g, n = switch
        final_games[p] = g
        for key, sign in ((games[p], -1), (g, 1)):
            score_sum[key] += sign * n * float(scores[p])

    pa = engine.arena_for("PresenceGrain")
    rows, found = pa.lookup_rows(players)
    require(bool(found.all()) and pa.live_count == PLAYERS, "players live")
    cols = {k: v.cpu().numpy()[rows] for k, v in pa.state.items()}
    require(bool(np.all(cols["heartbeats"] == hb_ticks)), "heartbeats")
    require(bool(np.all(cols["last_heartbeat"] == last_tick)),
            "last_heartbeat")
    require(bool(np.array_equal(cols["game"], final_games)), "game")

    ga = engine.arena_for("GameGrain")
    game_keys = np.arange(COLD_GAME + 1, dtype=np.int64)
    present = per_game > 0
    rows, found = ga.lookup_rows(game_keys)
    require(np.array_equal(found, present)
            and ga.live_count == int(present.sum()), "games live")
    rows = rows[present]
    updates = ga.state["updates"].cpu().numpy()[rows]
    require(bool(np.array_equal(updates, per_game[present])), "updates")
    total = ga.state["total_score"].cpu().numpy()[rows].astype(np.float64)
    oracle = score_sum[present]
    # float32 sums of k = updates positive terms in any order: Higham,
    # |err| <= (k - 1) * 2**-24 * sum|x| (+ O(2**-48)); k * 2**-24 covers it
    tol = updates * 2.0**-24 * oracle
    err = np.abs(total - oracle)
    require(bool(np.all(np.isfinite(total)) and np.all(err <= tol)),
            f"total_score off by {err.max()} (tolerance {tol.min()}..)")


def _bucket(delta: int) -> int:
    return 0 if delta <= 0 else min(delta.bit_length(), 15)


def check_ledger(engine, hb_ticks: int, fused_ticks: int, warm: int,
                 late: tuple = ()) -> None:
    """The latency histogram against the counts the run implies: every
    message counted once; heartbeats of unfused and replayed ticks at
    delta 1 (applied the tick after injection), of fused ticks at delta 0;
    game updates at delta 0, except the cold warm ticks' lanes, which miss
    and are delivered again at the drain after the warm phase, tick
    warm + 1, and the single updates that ``late`` lists by their delta
    (a rollback's cold key)."""
    snap = engine.ledger.snapshot()
    hb = snap["PresenceGrain.heartbeat"]["counts"]
    up = snap["GameGrain.update_game_status"]["counts"]
    require(sum(hb) == PLAYERS * hb_ticks and sum(up) == PLAYERS * hb_ticks,
            f"ledger totals {sum(hb)}/{sum(up)} != {PLAYERS * hb_ticks}")
    want_hb = [0] * 16
    want_hb[0] = PLAYERS * fused_ticks
    want_hb[1] = PLAYERS * (hb_ticks - fused_ticks)
    want_up = [0] * 16
    want_up[0] = PLAYERS * (hb_ticks - warm)
    for t in range(1, warm + 1):
        want_up[_bucket(warm + 1 - t)] += PLAYERS
    want_up[0] -= len(late)
    for delta in late:
        want_up[_bucket(delta)] += 1
    require(hb == want_hb, f"ledger heartbeat {hb} != {want_hb}")
    require(up == want_up, f"ledger game updates {up} != {want_up}")


def check_attribution(engine, games, hb_ticks, switch=None) -> dict:
    """The attribution plane at the default config against the numpy
    oracle of the load (the arguments as ``check_presence``'s): exactly,
    per arena, ``per_key_totals``, the counts column, the sketch
    (recomputed in numpy from the per-row totals with the oracle's own
    hash), the snapshot's top-k keys and counts in stable order (ties by
    row), ``hot_rows``, ``total_msgs`` and ``p99_to_mean`` (the float32
    mean total/nnz, as K9 computes it, so the 4-decimal quotient is
    exact); the per-method slot counts; and the Gini gauge within 2e-6 of
    the float64 oracle (the snapshot rounds it to 6 decimals; K9's
    float32 quotient adds at most one ulp)."""
    from orleans_tpu_torch.tensor.attribution import CMS_SEEDS

    att = engine.attribution
    snap = att.snapshot()
    msgs = PLAYERS * hb_ticks
    require(snap["methods"] == {"PresenceGrain.heartbeat": msgs,
                                "GameGrain.update_game_status": msgs},
            f"attribution slots {snap['methods']}")
    per_game = game_updates(games, hb_ticks, switch)
    oracles = {"PresenceGrain": (np.arange(PLAYERS, dtype=np.int64),
                                 np.full(PLAYERS, hb_ticks, np.int64)),
               "GameGrain": (np.nonzero(per_game)[0].astype(np.int64),
                             per_game[per_game > 0].astype(np.int64))}
    seeds = CMS_SEEDS[:att.cms_depth]
    out = {}
    for name, (keys, counts) in oracles.items():
        require(att.per_key_totals(name) == dict(zip(keys.tolist(),
                                                     counts.tolist())),
                f"attribution per-key totals of {name}")
        arena = engine.arena_for(name)
        rows, found = arena.lookup_rows(keys)
        require(bool(found.all()), f"{name}: attributed keys live")
        per_row = np.zeros(arena.capacity, np.int64)
        per_row[rows] = counts
        require(np.array_equal(att.counts_for(name).cpu().numpy(), per_row),
                f"attribution counts column of {name}")
        h = np_cms_hash(np.arange(arena.capacity), seeds, att.cms_width)
        want_cms = np.stack([np.bincount(h[d], weights=per_row,
                                         minlength=att.cms_width)
                             for d in range(att.cms_depth)]).astype(np.int64)
        require(np.array_equal(att.cms_for(name).cpu().numpy(), want_cms),
                f"attribution sketch of {name}")
        a = snap["arenas"][name]
        order = np.argsort(-per_row, kind="stable")[:att.top_k]
        want_hot = [(int(arena._key_of_row[r]), int(per_row[r]))
                    for r in order if per_row[r] > 0]
        require([(x["key"], x["msgs"]) for x in a["hot"]] == want_hot,
                f"attribution top-k of {name}")
        require(all(x["sketch_est"] >= x["msgs"] for x in a["hot"]),
                f"attribution sketch estimate of {name} undercounts")
        srt = np.sort(per_row)
        cap, nnz, total = len(srt), int((srt > 0).sum()), int(srt.sum())
        pos = min(max(cap - nnz + ((nnz - 1) * 99) // 100, 0), cap - 1)
        mean = np.float32(max(total, 1)) / np.float32(max(nnz, 1))
        rank = np.arange(1, nnz + 1, dtype=np.float64)
        gini = float(((2 * rank - nnz - 1) * srt[cap - nnz:]).sum()) \
            / (max(nnz, 1) * max(total, 1))
        require(a["total_msgs"] == total and a["skew"]["hot_rows"] == nnz
                and a["skew"]["p99_to_mean"]
                == round(float(srt[pos]) / float(mean), 4),
                f"attribution gauges of {name}: {a['skew']}")
        require(abs(a["skew"]["gini"] - gini) <= 2e-6,
                f"attribution gini of {name} {a['skew']['gini']} vs {gini}")
        out[name] = dict(total=total, hot_rows=nnz, gini=a["skew"]["gini"],
                         gini_oracle=gini, top=a["hot"][0])
    return out


def held_device_ms(fn, reps: int = 5, prepare=None):
    """Median device time of ``fn``'s work, enqueued while a spin kernel
    holds the stream; ``prepare`` runs before each sample, untimed.  A
    sample whose host time did not stay inside the spin is refused and the
    spin doubled; a bounded number of refusals fails the run."""
    spin = Timer.SPIN_CYCLES * 4
    refused = 0
    device, host = [], []
    while len(device) < reps:
        if prepare is not None:
            prepare()
        probe = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        probe[0].record()
        torch.cuda._sleep(spin)
        probe[1].record()
        t0 = time.perf_counter()
        fn()
        h = (time.perf_counter() - t0) * 1e3
        probe[2].record()
        probe[2].synchronize()
        spin_time = probe[0].elapsed_time(probe[1])
        if h < 0.8 * spin_time:
            device.append(probe[1].elapsed_time(probe[2]))
            host.append(h)
            continue
        refused += 1
        require(refused <= 6, f"held timing: the host took {h:.3f} ms, "
                f"longer than a {spin_time:.3f} ms spin, {refused} times")
        spin *= 2
    return float(np.median(device)), float(np.median(host))


def unfused_plane_ms(engines: dict, games_d, scores_d, n_ticks: int = 16,
                     reps: int = 3) -> dict:
    """Device time per tick of blocks of ``n_ticks`` steady unfused ticks
    (one attribution flush of 32 folds among them) on engines keyed by
    what they show: ``off`` (the plane off), ``proven`` (the plane on, its
    plans anchored on the block's own injector rows and game tensor, so
    every fold is host-proven) and ``checked`` (the plane on, its plans
    anchored on an earlier loader's tensors, so every fold is checked on
    the device).  Samples go in turns, the order reversed every other
    time; returns the medians."""
    players = np.arange(PLAYERS, dtype=np.int64)
    clock = {k: 5000 for k in engines}
    injectors = {k: e.make_injector("PresenceGrain", "heartbeat", players)
                 for k, e in engines.items()}

    def block(key):
        def run():
            for _ in range(n_ticks):
                clock[key] += 1
                injectors[key].inject({"game": games_d, "score": scores_d,
                                       "tick": np.int32(clock[key])})
                engines[key].run_tick()
        return run

    for key, e in engines.items():  # settle the plans and parked checks
        block(key)()
        e._drain_checks()
        if key == "proven":
            e.attribution._plans.clear()  # re-anchor on this injector
            block(key)()
            e._drain_checks()
    times = {k: [] for k in engines}
    order = list(engines)
    for _ in range(reps):
        for key in order + order[::-1]:
            # parked miss-checks drain (a sync) before each sample
            times[key].append(held_device_ms(
                block(key), reps=1, prepare=engines[key]._drain_checks)[0])
    return {k: float(np.median(v)) / n_ticks for k, v in times.items()}


def tick_device_ms(engine, games_d, scores_d, reps: int = 10):
    """Median device time of one steady tick, enqueued while a spin kernel
    holds the stream (so host overhead is out of the window), and the
    median host time to enqueue it."""
    injector = engine.make_injector(
        "PresenceGrain", "heartbeat", np.arange(PLAYERS, dtype=np.int64))
    device, host = [], []
    for i in range(reps):
        engine._drain_checks()  # no miss-check sync inside the window
        torch.cuda.synchronize()
        torch.cuda._sleep(Timer.SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        injector.inject({"game": games_d, "score": scores_d,
                         "tick": np.int32(1000 + i)})
        engine.run_tick()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end))
    return float(np.median(device)), float(np.median(host))


def require_launched(counts: dict, path: str,
                     names=PRESENCE_KERNELS) -> None:
    for name in names:
        require(counts.get(name, 0) > 0,
                f"{name} never launched on the {path} path")


def drive_unfused_path(dev, card: str):
    """Phase 4: the unfused tick (auto-fusion off), pipelined and synced,
    with the latency ledger and the attribution plane at the default
    config."""
    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.samples.presence import (
        presence_inputs,
        run_presence_load,
    )
    from orleans_tpu_torch.tensor.engine import TensorEngine

    _, games, scores = presence_inputs(PLAYERS, GAMES, seed=0)
    _build.reset_launch_counts()
    runs = {}
    attribution = {}
    for mode in ("pipelined", "latency"):
        engine = TensorEngine(device=dev, config=TensorEngineConfig(
            auto_fusion_ticks=0))
        stats = asyncio.run(run_presence_load(
            engine, n_players=PLAYERS, n_games=GAMES, n_ticks=TICKS, seed=0,
            measure_latency=(mode == "latency"), warm_ticks=WARM_TICKS))
        require(stats["messages"] == 2 * PLAYERS * TICKS, "stats messages")
        hb = WARM_TICKS + TICKS
        # every game-emit batch before the first miss-check drain (the
        # warm phase's flush) misses all its lanes and is delivered again
        check_presence(engine, games, scores, hb, TICKS,
                       2 * PLAYERS * hb + PLAYERS * WARM_TICKS)
        check_ledger(engine, hb, 0, WARM_TICKS)
        attribution[mode] = check_attribution(engine, games, hb)
        runs[mode] = stats
    # a loader that hands the engine a fresh copy of the games every tick:
    # the game emits' keys are a new tensor each tick, so their folds are
    # device-checked against the plan (K8 match, gated K7), as every emit
    # fold of the JAX engine is
    moving = FusedRun(dev, games, scores, moving=True, fuse=False)
    for _ in range(8):
        moving.tick()
    moving.finish()
    check_presence(moving.engine, games, scores, moving.ticks, moving.ticks,
                   2 * PLAYERS * moving.ticks + PLAYERS * WARM_TICKS)
    check_ledger(moving.engine, moving.ticks, 0, WARM_TICKS)
    attribution["moving"] = check_attribution(moving.engine, games,
                                              moving.ticks)
    moving_plans = moving.engine.attribution.stats()
    require(moving_plans["plan_checked"] >= 8, f"checked folds {moving_plans}")
    del moving
    counts = _build.launch_counts()
    print(f"launches on the unfused path: {json.dumps(counts)}", flush=True)
    require_launched(counts, "unfused")
    print(f"attribution, unfused: {json.dumps(attribution)}; plan counts "
          f"{json.dumps(engine.attribution.stats())}, moving loader "
          f"{json.dumps(moving_plans)}", flush=True)
    games_d = torch.from_numpy(games).to(dev)
    scores_d = torch.from_numpy(scores).to(dev)
    runs["tick_device_ms"], runs["tick_host_ms"] = tick_device_ms(
        engine, games_d, scores_d)
    # the plane's cost on the unfused tick: against an engine without it
    from orleans_tpu_torch.config import MetricsConfig
    engines = {}
    for key, on in (("off", False), ("proven", True)):
        engines[key] = TensorEngine(device=dev, config=TensorEngineConfig(
            auto_fusion_ticks=0), metrics=MetricsConfig(
            attribution_enabled=on))
        asyncio.run(run_presence_load(engines[key], n_players=PLAYERS,
                                      n_games=GAMES, n_ticks=2, seed=0,
                                      warm_ticks=1))
    engines["checked"] = engine
    runs["plane_ms"] = unfused_plane_ms(engines, games_d, scores_d)
    # the parked miss-check's copies of the emit's keys, mask and payload
    from orleans_tpu_torch.tensor.engine import _map_tree, _park_copy
    emit = {"score": scores_d, "count": torch.ones_like(games_d)}
    valid_mask = torch.ones(PLAYERS, dtype=torch.bool, device=dev)
    runs["park_copy_ms"] = Timer(dev)(lambda: (
        games_d.clone(), valid_mask.clone(), _map_tree(_park_copy, emit)))
    lat = runs["latency"]
    print(f"unfused presence {PLAYERS} players / {GAMES} games, {TICKS} "
          f"ticks after {WARM_TICKS} warm: "
          f"{runs['pipelined']['messages_per_sec']:.1f} messages/s "
          f"pipelined; tick p50 {lat['tick_p50_seconds'] * 1e3:.3f} ms, p99 "
          f"{lat['tick_p99_seconds'] * 1e3:.3f} ms synced; one steady tick "
          f"{runs['tick_device_ms']:.4f} ms on the device, "
          f"{runs['tick_host_ms']:.4f} ms to enqueue on the host; device "
          f"idle share synced {1 - runs['tick_device_ms'] / (lat['tick_p50_seconds'] * 1e3):.4f}; "
          f"on {card}", flush=True)
    return counts, runs


class LoadRun:
    """One engine driven by an inject-only loader, one tick at a time:
    warm ticks and a flush, then ticks until a number of windows ran.
    ``args_for(t)`` gives tick ``t``'s payload (ticks count from 1)."""

    def __init__(self, engine, injector, args_for, warm: int = WARM_TICKS):
        self.engine = engine
        self.af = engine.autofuser
        self.injector = injector
        self.args_for = args_for
        self.ticks = 0
        for _ in range(warm):
            self.tick()
        asyncio.run(self.engine.flush())

    def tick(self) -> None:
        self.ticks += 1
        self.injector.inject(self.args_for(self.ticks))
        self.engine.run_tick()
        for _ in range(self.engine.config.max_rounds_per_tick):
            if not any(self.engine.queues.values()):
                break
            self.engine.run_tick()
        require(not any(self.engine.queues.values()), "a tick did not drain")

    def windows(self, n: int, synced: bool = False) -> list:
        """Drive ticks until ``n`` more windows ran; returns, per window,
        (host ms of the tick that ran it, wall ms from the window's first
        inject to completion when ``synced``)."""
        out = []
        target = self.af.windows_run + n
        # detection takes auto_fusion_ticks ticks at most twice over
        limit = self.ticks + 4 * self.engine.config.auto_fusion_ticks \
            + 2 * n * self.engine.config.auto_fusion_window
        w_start = time.perf_counter()
        while self.af.windows_run < target:
            require(self.ticks < limit, f"{n} windows did not run by tick "
                    f"{limit}: {self.af.snapshot()}")
            if not self.af._buffer:
                w_start = time.perf_counter()
            before = self.af.windows_run
            t0 = time.perf_counter()
            self.tick()
            if self.af.windows_run > before:
                host = (time.perf_counter() - t0) * 1e3
                wall = None
                if synced:
                    self.engine.wait_completion()
                    wall = (time.perf_counter() - w_start) * 1e3
                out.append((host, wall))
        return out

    def finish(self) -> None:
        asyncio.run(self.engine.flush())
        self.engine.wait_completion()


class FusedRun(LoadRun):
    """A Presence engine at the default config driven by the inject-only
    loader.  ``moving``: the loader hands the engine a fresh copy of the
    players' games every tick (players may move), so ``game`` is a
    per-tick leaf of the window, not a static one.  ``attribution``: the
    plane on (the default config) or off (to time what it adds).
    ``fuse=False`` turns auto-fusion off."""

    def __init__(self, dev, games, scores, moving: bool = False,
                 attribution: bool = True, fuse: bool = True):
        from orleans_tpu_torch.config import MetricsConfig, TensorEngineConfig
        from orleans_tpu_torch.tensor.engine import TensorEngine

        engine = TensorEngine(
            device=dev, metrics=MetricsConfig(
                attribution_enabled=attribution),
            config=TensorEngineConfig(auto_fusion_ticks=16 if fuse else 0))
        engine.arena_for("PresenceGrain").reserve(PLAYERS)
        engine.arena_for("GameGrain").reserve(GAMES)
        injector = engine.make_injector(
            "PresenceGrain", "heartbeat", np.arange(PLAYERS, dtype=np.int64))
        # a copy: the rollback phase moves a player
        self.games_d = torch.from_numpy(games.copy()).to(dev)
        self.moving = moving
        self.scores_d = torch.from_numpy(scores).to(dev)

        def args_for(t: int) -> dict:
            game = self.games_d.clone() if self.moving else self.games_d
            return {"game": game, "score": self.scores_d,
                    "tick": np.int32(t)}

        super().__init__(engine, injector, args_for)


def window_device_ms(run: "FusedRun", reps: int = 5):
    """Median device time of one fused window (its input copies and graph
    replay), enqueued while a spin kernel holds the stream.  A sample
    whose host time (16 ticks) did not stay inside the spin is refused
    and the spin doubled; a bounded number of refusals fails the run."""

    def spin_ms(cycles: int) -> float:
        probe = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        probe[0].record()
        torch.cuda._sleep(cycles)
        probe[1].record()
        probe[1].synchronize()
        return probe[0].elapsed_time(probe[1])

    spin = Timer.SPIN_CYCLES * 4
    spin_time = spin_ms(spin)
    refused = 0
    device, host = [], []
    W = run.engine.config.auto_fusion_window
    verify_every = run.engine.config.auto_fusion_verify_windows
    while len(device) < reps:
        if run.af._chain_prog is None \
                or len(run.af._unverified) >= verify_every - 1:
            # a chain's first window pins the state and its last verifies
            # (a sync): time only the windows between
            run.windows(1)
            continue
        require(not run.af._buffer and run.af._program is not None,
                "window timing needs an engaged, empty window")
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        before = run.af.windows_run
        for _ in range(W):
            run.tick()
        h = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        require(run.af.windows_run == before + 1, "timed ticks ran no window")
        if h < 0.8 * spin_time:
            device.append(start.elapsed_time(end))
            host.append(h)
            continue
        refused += 1
        require(refused <= 6, f"window timing: the host took {h:.3f} ms, "
                f"longer than a {spin_time:.3f} ms spin, {refused} times")
        spin *= 2
        spin_time = spin_ms(spin)
    return float(np.median(device)), float(np.median(host))


def drive_fused_path(dev, card: str, unfused_tick_ms: float,
                     window_bound_ms: float):
    """Phase 5: the steady state — auto-fused windows as CUDA graphs."""
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.samples.presence import presence_inputs
    from orleans_tpu_torch.tensor.autofuse import pin_copy

    _, games, scores = presence_inputs(PLAYERS, GAMES, seed=0)
    W = 16
    _build.reset_launch_counts()
    out = {}

    # pipelined: 8 windows, checked; throughput over the 7 after the
    # first (detection and the build are a one-time cost)
    run = FusedRun(dev, games, scores)
    first = run.windows(1)
    ticks0 = run.ticks
    t0 = time.perf_counter()
    per_window = run.windows(WINDOWS - 1)
    run.finish()
    elapsed = time.perf_counter() - t0
    af = run.af.snapshot()
    require(af["windows_run"] == WINDOWS and af["ticks_fused"] == WINDOWS * W
            and af["windows_rolled_back"] == 0, f"pipelined autofuse {af}")
    check_presence(run.engine, games, scores, run.ticks, run.ticks,
                   2 * PLAYERS * run.ticks + PLAYERS * WARM_TICKS)
    require(run.engine.activation_passes == WARM_TICKS, "activation passes")
    check_ledger(run.engine, run.ticks, af["ticks_fused"], WARM_TICKS)
    out["attribution"] = {"pipelined": check_attribution(
        run.engine, games, run.ticks)}
    prog = run.af._program
    require(prog is not None and prog._graph is not None
            and prog.replays == WINDOWS, "the windows were not graph replays")
    measured = run.ticks - ticks0
    out["pipelined"] = dict(
        autofuse=af, ticks=measured, seconds=elapsed,
        messages_per_sec=2 * PLAYERS * measured / elapsed,
        first_window_host_ms=first[0][0], detection_ticks=ticks0
        - WARM_TICKS - W,
        window_host_ms=float(np.median([h for h, _ in per_window])),
        rebuilds=dict(prog.rebuilds), build_s=prog.build_seconds)
    # the fused path's launches: this run's and the rollback run's below
    counts = _build.launch_counts()
    report = _build.launch_report()
    for name in ("resolve_dense", "row_scatter", "seg_sum", "hist_count",
                 "attr_fold"):
        require(report[name]["replayed"] > 0, f"{name} never replayed")
    out["per_replay"] = dict(prog._per_replay)
    print(f"fused pipelined: {json.dumps(out['pipelined'])}", flush=True)

    # pin_copy: the chain-start copy of every touched arena's columns
    pins = {n: {c: torch.empty_like(v) for c, v in
                run.engine.arena_for(n).state.items()} for n in prog._touched}

    def pin_all():
        for n in prog._touched:
            pin_copy(run.engine.arena_for(n).state, pins[n])

    timer = Timer(dev)
    pin_ms = timer(pin_all)
    pin_bytes = 2 * sum(v.numel() * v.element_size()
                        for n in prog._touched
                        for v in run.engine.arena_for(n).state.values())
    out["pin_copy"] = dict(ms=pin_ms, host_ms=timer.host_ms,
                           bound_ms=bound(pin_bytes)[0], bytes=pin_bytes)
    del run, pins

    # synced per window, then the window's device time
    run = FusedRun(dev, games, scores)
    synced = run.windows(WINDOWS, synced=True)
    # the window with the attribution plane (the default) and without it,
    # in turns on, off, off, on
    run_off = FusedRun(dev, games, scores, attribution=False)
    run_off.windows(2)
    on, off = [], []
    for r, acc in ((run, on), (run_off, off), (run_off, off), (run, on)):
        acc.append(window_device_ms(r, reps=3))
    run_off.finish()
    del run_off
    dev_ms = float(np.median([d for d, _ in on]))
    dev_host_ms = float(np.median([h for _, h in on]))
    out["window_off_device_ms"] = float(np.median([d for d, _ in off]))
    run.finish()
    check_presence(run.engine, games, scores, run.ticks, run.ticks,
                   2 * PLAYERS * run.ticks + PLAYERS * WARM_TICKS)
    check_ledger(run.engine, run.ticks, run.af.ticks_fused, WARM_TICKS)
    out["attribution"]["synced"] = check_attribution(run.engine, games,
                                                     run.ticks)
    walls = np.asarray([w for _, w in synced])
    out["synced"] = dict(window_p50_ms=float(np.percentile(walls, 50)),
                         window_max_ms=float(walls.max()),
                         autofuse=run.af.snapshot())
    out["window_device_ms"] = dev_ms
    out["window_timed_host_ms"] = dev_host_ms
    del run

    # a forced rollback: with the games a per-tick leaf, one player moves
    # to a game no one has activated just after a verified chain, so every
    # tick of the next window sends to the cold key.  Its unfused ticks
    # fold the game emits device-checked (their keys are a new tensor
    # every tick).  The second half of the fused path's launch count.
    _build.reset_launch_counts()
    run = FusedRun(dev, games, scores, moving=True)
    run.windows(4)
    run.af._settle_chain()
    require(not run.af._unverified and not run.af._buffer, "chain settled")
    require(not run.engine._pending_checks
            and run.engine.config.miss_check_cap == W, "no parked checks")
    switched_at = run.ticks
    run.games_d[0] = COLD_GAME
    run.windows(1)
    require(run.af.windows_rolled_back == 0, "rolled back too early")
    run.af._settle_chain()   # verify: the cold key rolls the chain back
    require(run.af.windows_rolled_back == 1, "the cold key did not roll back")
    # the unfused replay parked one miss-check per tick, each missing the
    # cold key; the next tick starts with miss_check_cap of them parked,
    # drains them and delivers the W dropped updates, the one of replayed
    # tick k (1..W) W + 1 - k ticks after it was sent
    require(len(run.engine._pending_checks) == W, "replay's parked checks")
    run.windows(2)
    run.finish()
    af = run.af.snapshot()
    require(af["windows_rolled_back"] == 1, f"rollback run {af}")
    check_presence(run.engine, games, scores, run.ticks, run.ticks,
                   2 * PLAYERS * run.ticks
                   + PLAYERS * run.engine.activation_passes,
                   switch=(0, COLD_GAME, run.ticks - switched_at))
    require(run.engine.activation_passes == WARM_TICKS + W,
            f"activation passes {run.engine.activation_passes} != "
            f"{WARM_TICKS + W}: the cold key was not activated at one drain")
    check_ledger(run.engine, run.ticks, af["ticks_fused"], WARM_TICKS,
                 late=tuple(W + 1 - k for k in range(1, W + 1)))
    # exactly: the rolled-back window's folds are undone, each replayed
    # tick counts once
    out["attribution"]["rollback"] = check_attribution(
        run.engine, games, run.ticks,
        switch=(0, COLD_GAME, run.ticks - switched_at))
    more = _build.launch_counts()
    counts = {k: counts[k] + more[k] for k in counts}
    more = _build.launch_report()
    report = {k: {kind: v + more[k][kind] for kind, v in kinds.items()}
              for k, kinds in report.items()}
    print(f"launches on the fused path (the pipelined and the rollback "
          f"runs): {json.dumps(counts)}; by kind {json.dumps(report)}; one "
          f"replay = {json.dumps(out['per_replay'])}", flush=True)
    require_launched(counts, "fused")
    out["counts"], out["report"] = counts, report
    out["rollback"] = dict(autofuse=af,
                           activation_passes=run.engine.activation_passes,
                           rebuilds=dict(run.af._program.rebuilds)
                           if run.af._program is not None else {})
    del run

    fused_tick_ms = dev_ms / W
    out["window_bound_ms"] = window_bound_ms
    p = out["pipelined"]
    print(f"fused presence {PLAYERS} players / {GAMES} games, {WINDOWS} "
          f"windows of {W} ticks after {WARM_TICKS} warm and "
          f"{p['detection_ticks']} detection ticks: pipelined "
          f"{p['messages_per_sec']:.1f} messages/s over the {p['ticks']} "
          f"ticks after the first window; host {p['window_host_ms']:.4f} ms "
          f"per window for the tick that runs it (median), "
          f"{out['window_timed_host_ms']:.4f} ms for all {W} ticks of a "
          f"window; window build (discovery + capture) "
          f"{p['build_s'] * 1e3:.1f} ms; device "
          f"{dev_ms:.4f} ms per window (bound {window_bound_ms:.4f} by "
          f"bytes) = {fused_tick_ms:.4f} ms per fused "
          f"tick against {unfused_tick_ms:.4f} ms per unfused tick; synced "
          f"window p50 {out['synced']['window_p50_ms']:.4f} ms, max "
          f"{out['synced']['window_max_ms']:.4f} ms, device idle share "
          f"synced {1 - dev_ms / out['synced']['window_p50_ms']:.4f}; "
          f"pin_copy {out['pin_copy']['ms']:.4f} ms for "
          f"{out['pin_copy']['bytes']} bytes (bound "
          f"{out['pin_copy']['bound_ms']:.4f}); on {card}", flush=True)
    for mode in ("pipelined", "synced", "rollback"):
        print(f"autofuse {mode}: {json.dumps(out[mode]['autofuse'])}",
              flush=True)
    print(f"rollback run: {json.dumps(out['rollback'])}", flush=True)
    print(f"attribution, fused: {json.dumps(out['attribution'])}",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phases 6 and 7: wide keys (WidePresence) and the follower fan-out (Chirper)
# ---------------------------------------------------------------------------

def wide_inputs():
    """The WidePresence load: PLAYERS players over WIDE_GAMES wide games
    (jenkins hashes of game names); player 0 plays a game that is never
    pre-activated (the cold wide destination)."""
    from orleans_tpu_torch.samples.presence_wide import (
        wide_game_keys,
        wide_presence_inputs,
    )
    from orleans_tpu_torch.tensor.arena import split_wide_keys

    players, games, index, _words, scores = wide_presence_inputs(
        PLAYERS, WIDE_GAMES, seed=0)
    cold = wide_game_keys(WIDE_GAMES + 1)[-1]
    assign = games[index]
    assign[0] = cold
    hi, lo = split_wide_keys(assign)
    return dict(players=players, games=games, cold=cold, assign=assign,
                hi=hi, lo=lo, scores=scores)


def wide_variant_mirrors(dev, seed: int = 17) -> dict:
    """K10's other search plans, each with ``PLAYERS`` lanes of its live
    keys: a mirror the tree holds whole (2,048 rows, 1,500 keys) and one
    whose buckets of 128 lift in L2 (524,288 rows, 300,000 keys).  Name ->
    (live keys, ``device_index_wide``, hi, lo)."""
    from orleans_tpu_torch.samples import presence_wide  # noqa: F401
    from orleans_tpu_torch.tensor.arena import GrainArena, split_wide_keys
    from orleans_tpu_torch.tensor.vector_grain import vector_type

    rng = np.random.default_rng(seed)
    out = {}
    for name, n_keys, rows_cap in (("whole_2048", 1_500, 2048),
                                   ("lift_524288", 300_000, 1 << 19)):
        keys = np.unique(rng.integers(0, 2**63 - 1, n_keys, np.int64))
        arena = GrainArena(vector_type("WideGame"), dev, capacity=rows_cap)
        arena.resolve_rows(keys)
        hi, lo = (torch.from_numpy(w).to(dev)
                  for w in split_wide_keys(rng.choice(keys, PLAYERS)))
        out[name] = (len(keys), arena.device_index_wide(), hi, lo)
    return out


def chirper_graph():
    """The Chirper follow graph, 200,000 accounts, mean 25 followers, Zipf
    1.6, seed 0, built once for every phase that uses it, with its edges
    as numpy arrays for the oracle."""
    from orleans_tpu_torch.samples.chirper import build_follow_graph

    t0 = time.perf_counter()
    fan = build_follow_graph(ACCOUNTS, MEAN_FOLLOWERS, zipf_a=ZIPF, seed=0)
    fan.csr(torch.device("cpu"))  # the host CSR, once
    keys, offsets, dst = fan._csr_host
    n_edges = int(offsets[-1])
    src = np.repeat(keys.astype(np.int64), np.diff(offsets))
    graph = dict(fan=fan, src=src, dst=dst[:n_edges].astype(np.int64),
                 build_s=time.perf_counter() - t0)
    print(f"chirper graph: {ACCOUNTS} accounts, {n_edges} edges from "
          f"{len(keys)} sources, largest degree {int(np.diff(offsets).max())}"
          f", width {len(dst)}; built in {graph['build_s']:.1f} s on the "
          f"host", flush=True)
    return graph


def chat_push_csr(dev) -> tuple:
    """The streams plane's push CSR (``DeviceSubscriptions.push_csr``: stream
    keys, offsets, subscriber keys padded to a multiple of 256 with the
    sentinel) of the chat layout, 4,096 rooms over 1,000,000 users at 1.5
    memberships: the shape of its push path through K11."""
    from orleans_tpu_torch.samples.streams import build_membership
    from orleans_tpu_torch.tensor.streams_plane import DeviceSubscriptions

    subs = DeviceSubscriptions(None, "ChatUserGrain", "receive")
    subs.subscribe_many(*build_membership(CHAT_ROOMS, CHAT_USERS, CHAT_MEAN,
                                          seed=0))
    return subs.push_csr(dev)


def check_new_kernels(dev, timer, card: str, wide: dict, graph: dict):
    """K10 and K11 against their plain versions on the card: at the main
    paths' shapes and on adversarial inputs; each timed beside its bound,
    its plain version and a library yardstick."""
    from orleans_tpu_torch.kernels import fanout as kfan
    from orleans_tpu_torch.kernels import resolve
    from orleans_tpu_torch.samples import presence_wide  # noqa: F401
    from orleans_tpu_torch.tensor.arena import (
        GrainArena,
        mix32_np,
        split_wide_keys,
    )
    from orleans_tpu_torch.tensor.fanout import DeviceFanout
    from orleans_tpu_torch.tensor.vector_grain import vector_type

    rng = np.random.default_rng(4321)
    results = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def same(a, b):
        return all(torch.equal(x.reshape(-1), y.reshape(-1))
                   for x, y in zip(a, b))

    # -- K10 resolve_wide: the main path's mirror and lanes ------------------
    arena = GrainArena(vector_type("WideGame"), dev)
    arena.reserve(WIDE_GAMES)
    arena.resolve_rows(wide["games"])
    mirror = arena.device_index_wide()
    cap = mirror[0].shape[0]
    hi_d, lo_d = t(wide["hi"]), t(wide["lo"])
    valid_d = torch.ones(PLAYERS, dtype=torch.bool, device=dev)
    out = resolve.resolve_wide(*mirror, hi_d, lo_d, valid_d)
    require(same(out, resolve.resolve_wide_plain(*mirror, hi_d, lo_d,
                                                 valid_d)),
            "resolve_wide != plain (main path)")
    want_rows, _ = arena.lookup_rows(wide["assign"])
    require(int(out[1]) == 1 and np.array_equal(
        out[0].cpu().numpy()[1:], want_rows[1:]) and int(out[0][0]) == -1,
        "resolve_wide: the main path's lanes must hit but the cold one")
    # adversarial: colliding hashes, edge words, padding, narrow mode
    draws = np.unique(rng.integers(2**31, 2**63 - 1, 400_000,
                                   dtype=np.int64))
    h = mix32_np(*split_wide_keys(draws))
    _, inv, cnt = np.unique(h, return_inverse=True, return_counts=True)
    colliding = draws[cnt[inv] > 1]
    require(len(colliding) >= 8, "too few colliding wide keys drawn")
    edge = np.array([0, 5, 2**31 - 1, 2**31, 2**32 - 1, 2**32,
                     (2**31 - 1) << 32, ((2**31 - 1) << 32) | (2**32 - 1),
                     (1 << 32) | 2**31], np.int64)
    adv = GrainArena(vector_type("WideGame"), dev, capacity=1 << 14)
    adv.resolve_rows(np.unique(np.concatenate([colliding[::2], edge,
                                               draws[:5000]])))
    adv_mirror = adv.device_index_wide()
    pool = np.concatenate([colliding, edge, draws[:5000],
                           rng.integers(0, 2**63 - 1, 2000, np.int64)])
    a_hi, a_lo = split_wide_keys(rng.choice(pool, PLAYERS))
    a_valid = t(rng.random(PLAYERS) < 0.9)
    narrow = t(rng.choice(np.array([0, 5, 6, SENTINEL, -3, 2**31 - 2],
                                   np.int64), PLAYERS).astype(np.int32))
    for hi, lo, valid, what in ((t(a_hi), t(a_lo), a_valid, "adversarial"),
                                (None, narrow, a_valid, "narrow into wide")):
        counter = torch.full((1,), 11, dtype=torch.int32, device=dev)
        got = resolve.resolve_wide(*adv_mirror, hi, lo, valid, counter)
        want = resolve.resolve_wide_plain(*adv_mirror, hi, lo, valid)
        require(torch.equal(got[0], want[0])
                and int(counter[0]) == 11 + int(want[1]),
                f"resolve_wide != plain ({what})")
    h_d = resolve.mix32(hi_d, lo_d)

    def library_wide():
        idx = torch.searchsorted(mirror[0], h_d).clamp_(max=cap - 1)
        rows = mirror[1].index_select(0, idx).clamp_(min=0)
        return mirror[2].index_select(0, rows), mirror[3].index_select(0,
                                                                       rows)

    results["resolve_wide"] = dict(
        max_abs_err=0,
        library="torch.searchsorted + 3 index_select (no single call "
                "computes it: one probe, no word check, no miss count)",
        bound=wide_bound(len(wide["games"]), PLAYERS),
        **measure(timer,
                  lambda: resolve.resolve_wide(*mirror, hi_d, lo_d, valid_d),
                  lambda: resolve.resolve_wide_plain(*mirror, hi_d, lo_d,
                                                     valid_d),
                  library_wide))
    # the search's other plans: the whole mirror in the tree, and buckets
    wide_variants = []
    for name, (n_keys, v_mirror, v_hi, v_lo) in \
            wide_variant_mirrors(dev).items():
        got = resolve.resolve_wide(*v_mirror, v_hi, v_lo, valid_d)
        want = resolve.resolve_wide_plain(*v_mirror, v_hi, v_lo, valid_d)
        require(same(got, want) and int(want[1]) == 0,
                f"resolve_wide != plain ({name})")
        v_h = resolve.mix32(v_hi, v_lo)
        rows_cap = v_mirror[0].shape[0]

        def library_v(m_=v_mirror, h_=v_h, n_=rows_cap):
            idx = torch.searchsorted(m_[0], h_).clamp_(max=n_ - 1)
            rows = m_[1].index_select(0, idx).clamp_(min=0)
            return m_[2].index_select(0, rows), m_[3].index_select(0, rows)

        wide_variants.append(dict(
            name=name, max_abs_err=0,
            per=f"{PLAYERS} lanes against a mirror of {rows_cap} rows "
                f"({n_keys} keys), plan {resolve.resolve_plan(rows_cap)}",
            bound_ms=wide_bound(n_keys, PLAYERS)[0],
            **measure(timer,
                      lambda a=(*v_mirror, v_hi, v_lo, valid_d):
                      resolve.resolve_wide(*a),
                      lambda a=(*v_mirror, v_hi, v_lo, valid_d):
                      resolve.resolve_wide_plain(*a),
                      library_v)))
    results["resolve_wide"]["variants"] = wide_variants

    # -- K11 fanout_expand: the main path's publish round ---------------------
    fan = graph["fan"]
    csr = fan.csr(dev)
    src_d = torch.arange(ACCOUNTS, dtype=torch.int32, device=dev)
    ones_d = torch.ones(ACCOUNTS, dtype=torch.bool, device=dev)
    out = kfan.fanout_expand(*csr, src_d, ones_d)
    require(same(out, kfan.fanout_expand_plain(*csr, src_d, ones_d)),
            "fanout_expand != plain (main path)")
    n_edges = len(graph["dst"])
    require(int(out[3]) == n_edges and int(out[5]) == 0
            and int(out[2].sum()) == n_edges,
            f"fanout_expand: total {int(out[3])} != {n_edges} edges")
    # an empty graph, a round whose duplicate sources overflow the width, and
    # a round whose int32 scan wraps (offs not monotone: the per-slot search)
    top = int(np.argmax(np.bincount(graph["src"], minlength=ACCOUNTS)))
    dup = torch.cat([src_d, torch.full((40,), top, dtype=torch.int32,
                                       device=dev)])
    dup_valid = torch.ones(dup.shape[0], dtype=torch.bool, device=dev)
    empty = DeviceFanout(budget=1 << 12).csr(dev)
    wrap_csr = (t(np.array([3, 8, 11, 20], np.int32)),
                t(np.array([0, 5, 2**30 + 5, 2**31 - 9, 2**31 - 2],
                           np.int32)),
                t(rng.integers(0, 1000, 1 << 16).astype(np.int32)))
    wrap_src = t(np.array([3, 8, 8, 20, 11, 8, 3, 8, 99, 11] * 500,
                          np.int32))
    wrap_valid = t(rng.random(wrap_src.shape[0]) < 0.9)
    # scans that wrap back to a positive total: four lanes of a source of
    # 2**30 edges then one of 5 (total 5, its slots valid and gathered),
    # and five lanes of the source of 2**30 (total 2**30, past the width)
    back_dst = t(rng.integers(0, 1000, 300).astype(np.int32))
    back_valid = torch.ones(5, dtype=torch.bool, device=dev)
    back = (t(np.array([3, 8], np.int32)),
            t(np.array([0, 5, 2**30 + 5], np.int32)), back_dst,
            t(np.array([8, 8, 8, 8, 3], np.int32)), back_valid)
    back_past = (t(np.array([3, 8], np.int32)),
                 t(np.array([0, 2**30, 2**30 + 5], np.int32)), back_dst,
                 t(np.full(5, 3, np.int32)), back_valid)
    for args, what in (((*csr, dup, dup_valid), "overflowing round"),
                       ((*empty, src_d, ones_d), "empty graph"),
                       ((*wrap_csr, wrap_src, wrap_valid), "wrapping scan"),
                       (back, "scan wrapping back to 5"),
                       (back_past, "scan wrapping back to 2**30")):
        got = kfan.fanout_expand(*args)
        require(same(got, kfan.fanout_expand_plain(*args)),
                f"fanout_expand != plain ({what})")
    got = kfan.fanout_expand(*back)
    require(int(got[3]) == 5 and int(got[2].sum()) == 5
            and torch.equal(got[0][:5], back_dst[:5]),
            "fanout_expand: the scan wrapping back to 5 lost its slots")
    require(int(kfan.fanout_expand(*csr, dup, dup_valid)[5]) > 0,
            "the overflowing round dropped no lane")

    def k11_times(csr_, src, valid):
        keys, offsets, dst = csr_
        n, width, lanes = keys.shape[0], dst.shape[0], src.shape[0]
        idx = torch.searchsorted(keys, src).clamp_(max=n - 1)
        deg = torch.where((keys[idx] == src) & valid,
                          offsets[idx + 1] - offsets[idx], 0).long()
        total = int(deg.sum())
        lane_ids = torch.arange(lanes, device=dev)
        return dict(
            bound=bound(8 * n + 4 + 13 * width + 6 * lanes + 8,
                        int_ops=2 * lanes * math.ceil(math.log2(n + 1))
                        + 2 * width * math.ceil(math.log2(lanes + 1))),
            **measure(timer,
                      lambda: kfan.fanout_expand(*csr_, src, valid),
                      lambda: kfan.fanout_expand_plain(*csr_, src, valid),
                      lambda: torch.repeat_interleave(
                          lane_ids, deg, output_size=total)))

    results["fanout_expand"] = dict(
        max_abs_err=0,
        library="torch.repeat_interleave(deg, output_size=edges) "
                "(src_index only)",
        per="one launch (two kernels: the lane pass, a scan with decoupled "
            "look-back; the slot pass from each slot tile's first owner, or "
            "the per-slot search when the scan wraps), at the Chirper shape",
        **k11_times(csr, src_d, ones_d))
    # the streams plane's push path: every chat room publishes
    push = chat_push_csr(dev)
    push_src = push[0].clone()
    push_valid = torch.ones(push_src.shape[0], dtype=torch.bool, device=dev)
    require(same(kfan.fanout_expand(*push, push_src, push_valid),
                 kfan.fanout_expand_plain(*push, push_src, push_valid)),
            "fanout_expand != plain (streams push)")
    push_t = k11_times(push, push_src, push_valid)
    results["fanout_expand"]["variants"] = [dict(
        name="streams_push", max_abs_err=0,
        per=f"{push_src.shape[0]} rooms publishing through the chat push "
            f"CSR ({int(push[1][-1])} edges, width {push[2].shape[0]})",
        bound_ms=push_t.pop("bound")[0], **push_t)]
    for name in ("resolve_wide", "fanout_expand"):
        v = results[name]
        print(f"kernel {name}: {v['ms']:.4f} ms on the device, host "
              f"{v['host_ms']:.4f} (plain {v['plain_ms']:.4f}, library "
              f"{v['library_ms']:.4f}, bound {v['bound'][0]:.4f} by "
              f"{v['bound'][1]}); on {card}", flush=True)
        print_variants(name, v, card)
    return results


def ledger_counts(engine, key: str) -> list:
    return engine.ledger.snapshot()[key]["counts"]


def want_hist(at0: int, at1: int = 0, late: tuple = ()) -> list:
    """A ledger row: ``at0`` lanes at delta 0, ``at1`` at delta 1, one
    lane per delta in ``late``."""
    row = [0] * 16
    row[0] += at0
    row[1] += at1
    for delta in late:
        row[_bucket(delta)] += 1
    return row


def check_wide(engine, wide: dict, ticks: int, fused_ticks: int) -> None:
    """WidePresence against the numpy oracle of its load: heartbeats and
    updates exactly, total_score within Higham's bound, the cold game's
    warm-tick updates delivered again exactly once each (one activation
    pass per cold warm tick), the ledger and the attribution plane
    exactly."""
    pa = engine.arena_for("WidePresence")
    rows, found = pa.lookup_rows(wide["players"])
    require(bool(found.all()), "wide players live")
    require(bool(np.all(pa.state["heartbeats"].cpu().numpy()[rows]
                        == ticks)), "wide heartbeats")
    keys = np.append(wide["games"], wide["cold"])
    slot = np.searchsorted(np.sort(keys), wide["assign"])
    order = np.argsort(keys)
    per_game = np.zeros(len(keys), np.int64)
    per_game[order] = np.bincount(slot, minlength=len(keys)) * ticks
    score = np.zeros(len(keys), np.float64)
    score[order] = np.bincount(slot, weights=wide["scores"].astype(
        np.float64), minlength=len(keys)) * ticks
    ga = engine.arena_for("WideGame")
    present = per_game > 0
    grows, gfound = ga.lookup_rows(keys)
    require(bool(gfound[present].all()) and ga.has_wide_keys
            and ga.live_count == len(keys), "wide games live")
    updates = ga.state["updates"].cpu().numpy()[grows]
    require(np.array_equal(updates, per_game), "wide updates")
    total = ga.state["total_score"].cpu().numpy()[grows].astype(np.float64)
    err = np.abs(total - score)
    require(bool(np.all(err <= updates * 2.0**-24 * score)),
            f"wide total_score off by {err.max()}")
    require(engine.activation_passes == WARM_TICKS,
            f"wide activation passes {engine.activation_passes}")
    late = tuple(WARM_TICKS + 1 - k for k in range(1, WARM_TICKS + 1))
    require(ledger_counts(engine, "WidePresence.heartbeat") == want_hist(
        PLAYERS * fused_ticks, PLAYERS * (ticks - fused_ticks)),
        "wide ledger heartbeats")
    require(ledger_counts(engine, "WideGame.update") == want_hist(
        PLAYERS * ticks - WARM_TICKS, late=late), "wide ledger updates")
    att = engine.attribution
    require(att.snapshot()["methods"] == {
        "WidePresence.heartbeat": PLAYERS * ticks,
        "WideGame.update": PLAYERS * ticks}, "wide attribution slots")
    require(att.per_key_totals("WideGame") == {
        k: v for k, v in zip(keys.tolist(), per_game.tolist()) if v},
        "wide attribution per game")
    require(att.per_key_totals("WidePresence") == dict.fromkeys(
        wide["players"].tolist(), ticks), "wide attribution per player")


def check_chirper(engine, graph: dict, ticks: int, fused_ticks: int,
                  follow=None) -> None:
    """Chirper against the numpy oracle: per account ``published = T``,
    ``received = T * in-degree``, ``last_chirp`` the newest chirp id among
    its followees, ``checksum`` within Higham's bound of ``T * sum(src %
    97)``; ``follow = (src, dst, ticks)`` adds an edge for the last
    ``ticks`` ticks.  The ledger and the attribution plane exactly."""
    src, dst = graph["src"], graph["dst"]
    weight = np.full(len(src), ticks, np.int64)
    if follow is not None:
        src = np.append(src, follow[0])
        dst = np.append(dst, follow[1])
        weight = np.append(weight, follow[2])
    received = np.bincount(dst, weights=weight, minlength=ACCOUNTS)
    checksum = np.bincount(dst, weights=weight * (src % 97),
                           minlength=ACCOUNTS)
    newest = np.full(ACCOUNTS, -1, np.int64)
    np.maximum.at(newest, dst, src)
    last = np.where(newest >= 0, (ticks - 1) * ACCOUNTS + newest, -1)
    a = engine.arena_for("ChirperAccount")
    rows, found = a.lookup_rows(np.arange(ACCOUNTS, dtype=np.int64))
    require(bool(found.all()) and a.live_count == ACCOUNTS, "accounts live")
    cols = {k: v.cpu().numpy()[rows] for k, v in a.state.items()}
    require(bool(np.all(cols["published"] == ticks)), "published")
    require(np.array_equal(cols["received"], received), "received")
    require(np.array_equal(cols["last_chirp"], last), "last_chirp")
    err = np.abs(cols["checksum"].astype(np.float64) - checksum)
    require(bool(np.all(err <= received * 2.0**-24 * checksum)),
            f"checksum off by {err.max()}")
    deliveries = int(weight.sum())
    require(ledger_counts(engine, "ChirperAccount.publish") == want_hist(
        ACCOUNTS * fused_ticks, ACCOUNTS * (ticks - fused_ticks)),
        "chirper ledger publish")
    require(ledger_counts(engine, "ChirperAccount.new_chirp")
            == want_hist(deliveries), "chirper ledger new_chirp")
    att = engine.attribution
    require(att.snapshot()["methods"] == {
        "ChirperAccount.publish": ACCOUNTS * ticks,
        "ChirperAccount.new_chirp": deliveries}, "chirper attribution slots")
    require(att.per_key_totals("ChirperAccount") == dict(zip(
        range(ACCOUNTS), (ticks + received.astype(np.int64)).tolist())),
        "chirper attribution per account")


def path_timings(run: LoadRun, msgs_per_tick: int, n_ticks: int) -> dict:
    """Pipelined messages/s over ``n_ticks`` ticks to device completion,
    and the device and host ms of one tick (held timing over blocks of 4
    ticks, parked checks drained before each)."""
    eng = run.engine
    # earlier phases' engines are reference cycles (engine ↔ auto-fuser):
    # collect them now, not inside the timed ticks (a collection freeing
    # their device memory took up to 120 ms inside one tick)
    gc.collect()
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        run.tick()
    run.finish()
    elapsed = time.perf_counter() - t0

    def block():
        for _ in range(4):
            run.tick()

    dev_ms, host_ms = held_device_ms(block, reps=3,
                                     prepare=eng._drain_checks)
    run.finish()
    return dict(messages_per_sec=msgs_per_tick * n_ticks / elapsed,
                tick_device_ms=dev_ms / 4, tick_host_ms=host_ms / 4)


def fused_timings(run: LoadRun, msgs_per_tick: int) -> dict:
    """Windows after the first, pipelined: messages/s to completion (the
    flush that verifies the chain included); then the device ms of one
    window (``window_device_ms``)."""
    run.windows(1)
    run.engine.wait_completion()
    gc.collect()
    ticks0 = run.ticks
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    events[0].record()
    t0 = time.perf_counter()
    per_window = run.windows(NEW_WINDOWS - 1)
    run.finish()
    elapsed = time.perf_counter() - t0
    events[1].record()
    events[1].synchronize()
    ticks = run.ticks - ticks0
    dev_ms, host_ms = window_device_ms(run, reps=3)
    return dict(messages_per_sec=msgs_per_tick * ticks / elapsed,
                pipelined_ticks=ticks,
                pipelined_s=elapsed,
                pipelined_stream_ms=events[0].elapsed_time(events[1]),
                window_host_ms=float(np.median([h for h, _ in per_window])),
                window_device_ms=dev_ms, window_timed_host_ms=host_ms)


def idle_share(f: dict) -> float:
    """The device's idle share over a fused path's pipelined windows:
    1 - (windows x one window's device time) / the stream's elapsed
    time between events around them."""
    busy = f["window_device_ms"] * f["pipelined_ticks"] / 16
    return 1 - busy / f["pipelined_stream_ms"]


def window_bound(parts, per_replay: dict, what: str) -> float:
    """One fused window's bound, as the Presence window's: the sum over
    the window's kernel launches of each launch's bound (the bytes it
    must move, each input read once and each output written once; the
    plain torch operations between the launches are not counted).
    ``parts`` lists (kernel, launches a window, bound ms a launch); their
    launches must be the window's captured ones."""
    counts = {}
    for name, n, _ms in parts:
        counts[name] = counts.get(name, 0) + n
    require(counts == {k: v for k, v in per_replay.items() if v},
            f"{what} window bound: launches {counts} != the window's "
            f"{per_replay}")
    return sum(n * ms for _name, n, ms in parts)


def fold_bounds(lanes_rows, weighted_rows) -> list:
    """K7's parts of a window: a counts-only fold per (lanes, rows they
    touch) a tick, 16 times, and a weighted fold per (arena capacity,
    live rows) once — the bytes of check_attr_kernels' variants, the
    sketch buckets those rows touch counted."""
    from orleans_tpu_torch.tensor.attribution import CMS_SEEDS

    def buckets(n):
        h = np_cms_hash(np.arange(n), CMS_SEEDS[:4], 8192)
        return sum(len(np.unique(h[d])) for d in range(4))

    return [("attr_fold", 16, bound(5 * lanes + 8 * rows + 8)[0])
            for lanes, rows in lanes_rows] + [
        ("attr_fold", 1, bound(4 * cap + 8 * live + 8 * buckets(live),
                               int_ops=cap * 12 * 4)[0])
        for cap, live in weighted_rows]


def drive_wide_path(dev, card: str, wide: dict) -> dict:
    """Phase 6: WidePresence, 1,000,000 players and 10,000 wide games,
    unfused (auto-fusion off), then auto-fused at the default config;
    launches counted per path."""
    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.samples import presence_wide  # noqa: F401
    from orleans_tpu_torch.tensor.engine import TensorEngine

    hi_d, lo_d = (torch.from_numpy(w).to(dev) for w in (wide["hi"],
                                                         wide["lo"]))
    scores_d = torch.from_numpy(wide["scores"]).to(dev)

    def make(fuse: bool) -> LoadRun:
        eng = TensorEngine(device=dev, config=TensorEngineConfig(
            auto_fusion_ticks=16 if fuse else 0))
        eng.arena_for("WidePresence").reserve(PLAYERS)
        eng.arena_for("WideGame").reserve(WIDE_GAMES)
        eng.arena_for("WideGame").resolve_rows(wide["games"])
        inj = eng.make_injector("WidePresence", "heartbeat",
                                wide["players"])
        return LoadRun(eng, inj, lambda t: {
            "game_hi": hi_d, "game_lo": lo_d, "score": scores_d,
            "tick": np.int32(t)})

    out = {"counts": {}, "report": {}}
    _build.reset_launch_counts()
    run = make(fuse=False)
    out["unfused"] = path_timings(run, 2 * PLAYERS, TICKS)
    check_wide(run.engine, wide, run.ticks, 0)
    out["counts"]["wide_unfused"] = _build.launch_counts()
    require_launched(out["counts"]["wide_unfused"], "wide unfused",
                     WIDE_KERNELS)
    del run

    _build.reset_launch_counts()
    run = make(fuse=True)
    out["fused"] = fused_timings(run, 2 * PLAYERS)
    run.finish()
    af = run.af.snapshot()
    require(af["windows_rolled_back"] == 0 and af["windows_run"]
            >= NEW_WINDOWS, f"wide autofuse {af}")
    check_wide(run.engine, wide, run.ticks, af["ticks_fused"])
    prog = run.af._program
    require(prog is not None and prog._graph is not None
            and prog.replays == af["windows_run"], "wide windows not replays")
    out["counts"]["wide_fused"] = _build.launch_counts()
    out["report"]["wide_fused"] = _build.launch_report()
    require_launched(out["counts"]["wide_fused"], "wide fused", WIDE_KERNELS)
    require(out["report"]["wide_fused"]["resolve_wide"]["replayed"] > 0,
            "resolve_wide never replayed")
    out["fused"].update(autofuse=af, rebuilds=dict(prog.rebuilds),
                        per_replay=dict(prog._per_replay))
    out["caps"] = {n: run.engine.arena_for(n).capacity
                   for n in ("WidePresence", "WideGame")}
    u, f = out["unfused"], out["fused"]
    print(f"wide presence {PLAYERS} players / {WIDE_GAMES} wide games: "
          f"unfused {u['messages_per_sec']:.1f} messages/s pipelined over "
          f"{TICKS} ticks, one tick {u['tick_device_ms']:.4f} ms on the "
          f"device, {u['tick_host_ms']:.4f} ms on the host; fused "
          f"{f['messages_per_sec']:.1f} messages/s over the windows after "
          f"the first, {f['window_device_ms']:.4f} ms per window of 16 on "
          f"the device = {f['window_device_ms'] / 16:.4f} ms per fused "
          f"tick, host {f['window_host_ms']:.4f} ms for the tick that runs "
          f"a window; autofuse {json.dumps(af)}; one replay = "
          f"{json.dumps(f['per_replay'])}; on {card}", flush=True)
    print(f"wide fused pipelined: {f['pipelined_ticks']} ticks in "
          f"{f['pipelined_s'] * 1e3:.3f} ms on the host clock, "
          f"{f['pipelined_stream_ms']:.3f} ms between stream events; "
          f"device idle share {idle_share(f):.4f}", flush=True)
    return out


def drive_chirper_path(dev, card: str, graph: dict) -> dict:
    """Phase 7: Chirper, 200,000 accounts, mean 25 followers, unfused,
    then auto-fused at the default config, then a follow() while the
    auto-fuser holds buffered ticks (they run first, on the old graph;
    the next window rebuilds on the new one); launches counted per path."""
    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.samples import chirper  # noqa: F401
    from orleans_tpu_torch.tensor.engine import TensorEngine, _map_tree
    from orleans_tpu_torch.tensor.engine import _park_copy

    fan = graph["fan"]
    base_d = torch.arange(ACCOUNTS, dtype=torch.int32, device=dev)
    accounts = np.arange(ACCOUNTS, dtype=np.int64)
    msgs = ACCOUNTS + len(graph["dst"])

    def make(fuse: bool) -> LoadRun:
        eng = TensorEngine(device=dev, config=TensorEngineConfig(
            auto_fusion_ticks=16 if fuse else 0))
        eng.register_fanout("ChirperAccount", "publish", fan,
                            "ChirperAccount", "new_chirp")
        eng.arena_for("ChirperAccount").reserve(ACCOUNTS)
        inj = eng.make_injector("ChirperAccount", "publish", accounts)
        return LoadRun(eng, inj, lambda t: {
            "chirp_id": base_d + (t - 1) * ACCOUNTS})

    out = {"counts": {}, "report": {}}
    _build.reset_launch_counts()
    run = make(fuse=False)
    out["unfused"] = path_timings(run, msgs, TICKS)
    check_chirper(run.engine, graph, run.ticks, 0)
    out["counts"]["chirper_unfused"] = _build.launch_counts()
    require_launched(out["counts"]["chirper_unfused"], "chirper unfused",
                     CHIRPER_KERNELS)
    # the parked fan-out check's copies of the publish round's keys and
    # payload: once per unfused Chirper tick
    args = {"chirp_id": base_d + 1}
    out["unfused"]["fanout_check_copy_ms"] = Timer(dev)(
        lambda: (base_d.clone(), _map_tree(_park_copy, args)))
    del run

    _build.reset_launch_counts()
    run = make(fuse=True)
    out["fused"] = fused_timings(run, msgs)
    run.finish()
    af = run.af.snapshot()
    require(af["windows_rolled_back"] == 0, f"chirper autofuse {af}")
    check_chirper(run.engine, graph, run.ticks, af["ticks_fused"])
    prog = run.af._program
    require(prog is not None and prog._graph is not None
            and prog.replays == af["windows_run"],
            "chirper windows not replays")
    out["fused"]["per_replay"] = dict(prog._per_replay)
    # a follow() with ticks buffered: an account nobody followed gains a
    # follower (a new source row of the CSR)
    run.windows(1)
    for _ in range(5):
        run.tick()
    require(bool(run.af._buffer), "no tick buffered before the follow")
    sources = set(np.unique(graph["src"]).tolist())
    top = next(a for a in range(ACCOUNTS) if a not in sources)
    new_follower = (top + 1) % ACCOUNTS
    version = fan.version
    fan.follow(top, new_follower)
    followed_at = run.ticks
    run.windows(2)
    run.finish()
    require(fan.version == version + 1, "the follow graph did not rebuild")
    af = run.af.snapshot()
    require(af["windows_rolled_back"] == 0, f"chirper autofuse {af}")
    require(prog.rebuilds["fanout_rebuild"] == 1,
            f"window rebuilds {dict(prog.rebuilds)}")
    check_chirper(run.engine, graph, run.ticks, af["ticks_fused"],
                  follow=(top, new_follower, run.ticks - followed_at))
    out["counts"]["chirper_fused"] = _build.launch_counts()
    out["report"]["chirper_fused"] = _build.launch_report()
    require_launched(out["counts"]["chirper_fused"], "chirper fused",
                     CHIRPER_KERNELS)
    require(out["report"]["chirper_fused"]["fanout_expand"]["replayed"] > 0,
            "fanout_expand never replayed")
    out["fused"].update(autofuse=af, rebuilds=dict(prog.rebuilds))
    arena = run.engine.arena_for("ChirperAccount")
    out["caps"] = {"ChirperAccount": arena.capacity,
                   "dense": arena.dense_index().shape[0]}
    u, f = out["unfused"], out["fused"]
    print(f"chirper {ACCOUNTS} accounts / {len(graph['dst'])} edges: "
          f"unfused {u['messages_per_sec']:.1f} messages/s pipelined over "
          f"{TICKS} ticks, one tick {u['tick_device_ms']:.4f} ms on the "
          f"device, {u['tick_host_ms']:.4f} ms on the host (the parked "
          f"fan-out check's copies {u['fanout_check_copy_ms']:.4f} ms); "
          f"fused {f['messages_per_sec']:.1f} messages/s over the windows "
          f"after the first, {f['window_device_ms']:.4f} ms per window of "
          f"16 on the device = {f['window_device_ms'] / 16:.4f} ms per "
          f"fused tick, host {f['window_host_ms']:.4f} ms for the tick "
          f"that runs a window; after the follow: rebuilds "
          f"{json.dumps(f['rebuilds'])}, autofuse {json.dumps(af)}; one "
          f"replay = {json.dumps(f['per_replay'])}; on {card}", flush=True)
    print(f"chirper fused pipelined: {f['pipelined_ticks']} ticks in "
          f"{f['pipelined_s'] * 1e3:.3f} ms on the host clock, "
          f"{f['pipelined_stream_ms']:.3f} ms between stream events; "
          f"device idle share {idle_share(f):.4f}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 8: the grain lifecycle and the timers plane
# ---------------------------------------------------------------------------

def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def harvest_edge_columns(n: int):
    """Slot columns whose dues, periods and clock make ``now - due`` and
    ``due + steps * period`` overflow int32 (they wrap, as in JAX)."""
    key = np.arange(n, dtype=np.int32)
    key[0] = SENTINEL
    pat_d = [0, -2**31 + 1, -2**31 + 1, -5, 2**31 - 1, 2**31 - 4, 7, -2**30,
             -2**31 + 7, 0, 2**31 - 1, 5]
    pat_p = [0, 1, 2**31 - 1, 3, 7, 2**31 - 1, 2**30, 2**30 + 5, 1,
             2**31 - 1, 0, 2]
    due = np.resize(np.array(pat_d, np.int64), n).astype(np.int32)
    period = np.resize(np.array(pat_p, np.int64), n).astype(np.int32)
    name = (np.arange(n) % 5).astype(np.int32)
    return key, due, period, name


def check_lifecycle_kernels(dev, timer, card: str) -> dict:
    """K12–K15 against their plain versions on the card, at the shapes of
    the collection and timers paths and on adversarial inputs; each timed
    beside its bound, its plain version and (K13) a library yardstick."""
    from orleans_tpu_torch.kernels import lifecycle as klc
    from orleans_tpu_torch.kernels import timers as ktm

    rng = np.random.default_rng(2468)
    results = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # -- K12 idle_mask: the collection sweep over the arena -------------------
    cap = 1 << 20  # Presence at 500,000 players after reserve()
    dev_clock = rng.integers(0, 400, cap).astype(np.int32)
    host_clock = rng.integers(0, 400, cap).astype(np.int32)
    host_clock[::97] = 2**31 - 1   # the clipped edges
    dev_clock[::89] = 0
    live = rng.random(cap) < 0.5
    dc, hc, lv = t(dev_clock), t(host_clock), t(live)
    for cutoff in (-2**31 + 1, 0, 200, 2**31 - 1):
        got = klc.idle_mask(dc, hc, lv, cutoff)
        want = klc.idle_mask_plain(dc, hc, lv, cutoff)
        require(torch.equal(got, want), f"idle_mask != plain ({cutoff})")
    results["idle_mask"] = dict(
        max_abs_err=0, library=None,
        library_note="no single PyTorch call: the shortest expression is "
                     "the plain version, live & (maximum(dev, host) < "
                     "cutoff), timed as plain_ms",
        bound=bound(10 * cap),
        **measure(timer, lambda: klc.idle_mask(dc, hc, lv, 200),
                  lambda: klc.idle_mask_plain(dc, hc, lv, 200), None))

    # -- K13 gather_rows: one write-back chunk of every state column ----------
    m = COLL_CHUNK
    rows = rng.choice(cap, m, replace=False).astype(np.int32)
    rows_d = t(rows)
    cols = {"int32": t(rng.integers(-2**31, 2**31 - 1, cap, dtype=np.int64)
                       .astype(np.int32)),
            "float32": t(rng.standard_normal(cap).astype(np.float32)),
            "width 3": t(rng.standard_normal((cap, 3)).astype(np.float32))}
    padded = np.zeros(_pow2(m + 77), np.int32)
    padded[:m + 77] = rng.integers(0, cap, m + 77)
    padded[5], padded[9] = -3, cap + 11   # clipped into [0, cap)
    for what, col in cols.items():
        for r in (rows_d, t(padded)):
            require(torch.equal(klc.gather_rows(col, r),
                                klc.gather_rows_plain(col, r)),
                    f"gather_rows != plain ({what})")
    col = cols["int32"]
    clamped = rows_d.clamp(0, cap - 1).long()
    results["gather_rows"] = dict(
        max_abs_err=0,
        library="torch.index_select on rows clamped beforehand (the clamp "
                "not timed)",
        bound=bound(12 * m),
        **measure(timer, lambda: klc.gather_rows(col, rows_d),
                  lambda: klc.gather_rows_plain(col, rows_d),
                  lambda: torch.index_select(col, 0, clamped)))

    # -- K14 timers_write: the 2M-timer arm -----------------------------------
    n_slots = 2_097_152 + 1     # the plane's columns after growing to 2M
    w = _pow2(TIMERS_N)
    slots = np.zeros(w, np.int32)
    slots[:TIMERS_N] = rng.permutation(np.arange(1, n_slots))[:TIMERS_N]
    vals = [np.full(w, SENTINEL, np.int32), np.zeros(w, np.int32),
            np.zeros(w, np.int32), np.zeros(w, np.int32)]
    vals[0][:TIMERS_N] = rng.integers(0, TIMERS_N, TIMERS_N)
    vals[1][:TIMERS_N] = rng.integers(1, 65, TIMERS_N)
    vals[2][:TIMERS_N] = 1
    vals[3][:TIMERS_N] = np.where(rng.random(TIMERS_N) < 0.5, 0, 8)
    idx_d = t(slots)
    vals_d = [t(v) for v in vals]

    def fresh_columns():
        return [torch.full((n_slots,), SENTINEL, dtype=torch.int32,
                           device=dev)] + [
            torch.zeros(n_slots, dtype=torch.int32, device=dev)
            for _ in range(3)]

    a, b = fresh_columns(), fresh_columns()
    ktm.timers_write(*a, idx_d, *vals_d)
    ktm.timers_write_plain(*b, idx_d, *vals_d)
    require(all(torch.equal(x, y) for x, y in zip(a, b)),
            "timers_write != plain (the 2M arm)")
    # adversarial: a small write with a dropped slot and pad lanes
    small = np.zeros(16, np.int32)
    small[:11] = rng.choice(np.arange(1, 4096), 11, replace=False)
    small[3] = n_slots + 9
    sv = [np.full(16, SENTINEL, np.int32)] + [np.zeros(16, np.int32)] * 3
    sv = [v.copy() for v in sv]
    for v, hi in zip(sv, (1 << 20, 2**31 - 1, 4, 2**31 - 1)):
        v[:11] = rng.integers(0, hi, 11)
    ktm.timers_write(*a, t(small), *(t(v) for v in sv))
    ktm.timers_write_plain(*b, t(small), *(t(v) for v in sv))
    require(all(torch.equal(x, y) for x, y in zip(a, b)),
            "timers_write != plain (pads, dropped slot)")
    cols_w = fresh_columns()
    results["timers_write"] = dict(
        max_abs_err=0, library=None,
        library_note="no single PyTorch call: the shortest expression is "
                     "four index_put_ calls, timed as plain_ms",
        bound=bound(32 * w),
        **measure(timer, lambda: ktm.timers_write(*cols_w, idx_d, *vals_d),
                  lambda: ktm.timers_write_plain(*cols_w, idx_d, *vals_d),
                  None))

    # -- K15 timers_harvest: one tick's due bucket of the 2M headline ---------
    due_w = TIMERS_N // TIMERS_SPREAD        # 31,250 due slots a tick
    now = 1000
    key = rng.integers(0, TIMERS_N, n_slots).astype(np.int32)
    key[0] = SENTINEL
    key[rng.random(n_slots) < 0.05] = SENTINEL    # freed / stale slots
    due = rng.integers(now - 3, now + 64, n_slots).astype(np.int32)
    period = np.where(rng.random(n_slots) < 0.3,
                      rng.integers(1, 16, n_slots), 0).astype(np.int32)
    name = rng.integers(0, 3, n_slots).astype(np.int32)
    hidx = np.zeros(_pow2(due_w), np.int32)
    hidx[:due_w] = rng.choice(np.arange(1, n_slots), due_w, replace=False)
    hidx_d = t(hidx)
    base = [t(key), t(due), t(period), t(name)]

    def harvest_pair(cols4, idx, now_):
        k1, d1 = cols4[0].clone(), cols4[1].clone()
        k2, d2 = cols4[0].clone(), cols4[1].clone()
        got = ktm.timers_harvest(k1, d1, cols4[2], cols4[3], idx, now_)
        want = ktm.timers_harvest_plain(k2, d2, cols4[2], cols4[3], idx,
                                        now_)
        return (torch.equal(k1, k2) and torch.equal(d1, d2)
                and all(torch.equal(x, y) for x, y in zip(got, want)))

    require(harvest_pair(base, hidx_d, now), "timers_harvest != plain "
            "(the headline bucket, re-arms, one-shots, stale slots)")
    edge = [t(c) for c in harvest_edge_columns(4096)]
    eidx = t(np.concatenate([rng.choice(np.arange(1, 4096), 3000,
                                        replace=False).astype(np.int32),
                             np.zeros(1096, np.int32)]))
    for now_ in (0, 9, 2**31 - 1, 2**31 - 2, -2**31 + 10, 2**30):
        require(harvest_pair(edge, eidx, now_),
                f"timers_harvest != plain (int32 edges, now={now_})")
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    out = ktm.timers_harvest(*[c.clone() for c in base[:2]], base[2],
                             base[3], empty, now)
    require(all(x.shape == (0,) for x in out), "empty harvest")
    # timed on the bucket as the 2M headline hands it to K15: every lane
    # live and due on this tick, a one-shot; the harvest frees its slots
    # in place, so each timed run starts from a fresh copy of the bucket
    head = [key.copy(), due.copy(), period.copy()]
    lanes = hidx[:due_w]
    head[0][lanes] = rng.integers(0, TIMERS_N, due_w)
    head[1][lanes] = now
    head[2][lanes] = 0
    head = [t(c) for c in head] + [base[3]]
    require(harvest_pair(head, hidx_d, now),
            "timers_harvest != plain (the headline's one-shot bucket)")
    hk, hd = head[0].clone(), head[1].clone()

    def restore():
        hk.copy_(head[0])
        hd.copy_(head[1])

    results["timers_harvest"] = dict(
        max_abs_err=0, library=None,
        library_note="none: no PyTorch call gathers, re-arms and frees "
                     "in one",
        bound=bound(33 * due_w),
        **measure(timer,
                  lambda: ktm.timers_harvest(hk, hd, head[2], head[3],
                                             hidx_d, now),
                  lambda: ktm.timers_harvest_plain(hk, hd, head[2],
                                                   head[3], hidx_d, now),
                  None, setup=restore))
    for name_ in ("idle_mask", "gather_rows", "timers_write",
                  "timers_harvest"):
        v = results[name_]
        lib = f"{v['library_ms']:.4f}" if v["library_ms"] is not None \
            else "none"
        print(f"kernel {name_}: {v['ms']:.4f} ms on the device, host "
              f"{v['host_ms']:.4f} (plain {v['plain_ms']:.4f}, library "
              f"{lib}, bound {v['bound'][0]:.4f} by {v['bound'][1]}); on "
              f"{card}", flush=True)
    return results


def _presence_payload(games, ks, tick: int) -> dict:
    return {"game": games[:len(ks)],
            "score": np.ones(len(ks), np.float32),
            "tick": np.full(len(ks), tick, np.int32)}


def collection_run(dev, budget_s: float, threshold: float) -> dict:
    """bench.py's ``_collection_scenario`` on the card, with its oracle:
    activate every player, settle into the hot subset's steady state, let
    the tick-interleaved collector evict the idle majority with columnar
    write-back, then re-activate one evicted player through the store.
    Checks every live row, every evicted key's record, the probe and the
    attribution totals exactly."""
    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.samples import presence  # noqa: F401
    from orleans_tpu_torch.tensor.engine import TensorEngine
    from orleans_tpu_torch.tensor.persistence import MemoryVectorStore

    n, hot, chunk = COLL_GRAINS, COLL_HOT, COLL_CHUNK
    cfg = TensorEngineConfig(
        auto_fusion_ticks=0, collection_idle_ticks=COLL_IDLE,
        collection_every_ticks=COLL_EVERY,
        collection_pause_budget_s=budget_s, collection_chunk_rows=chunk,
        compact_fragmentation_threshold=threshold)
    store = MemoryVectorStore()
    engine = TensorEngine(device=dev, config=cfg, store=store)
    keys = np.arange(n, dtype=np.int64)
    games = (keys % COLL_GAMES).astype(np.int32)
    hb = np.zeros(n, np.int64)      # the oracle: heartbeats per player
    last = np.zeros(n, np.int64)    # and the tick of the last one

    def drive(inj, n_ticks, stalls=None):
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            tick = engine.tick_number
            inj.inject(_presence_payload(games, inj.keys, tick))
            hb[inj.keys] += 1
            last[inj.keys] = tick
            engine.run_tick()
            if stalls is not None:
                stalls.append(engine.last_tick_stages.get("collect", 0.0))
        asyncio.run(engine.flush())
        return time.perf_counter() - t0

    drive(engine.make_injector("PresenceGrain", "heartbeat", keys), 4)
    arena = engine.arena_for("PresenceGrain")
    # warm the collection machinery on a sacrificial key range outside
    # the measured window (bench.py does the same)
    warm = np.arange(n, n + chunk, dtype=np.int64)
    arena.resolve_rows(warm, tick=0)
    arena.select_idle_rows(0)
    engine.arena_for("GameGrain").select_idle_rows(0)
    arena.deactivate_idle_rows(arena.lookup_rows(warm)[0], 10**9,
                               write_back=True)
    gen0 = arena.generation
    hot_inj = engine.make_injector("PresenceGrain", "heartbeat", keys[:hot])
    drive(hot_inj, 16)
    msgs0 = engine.messages_processed
    pre_s = drive(hot_inj, 16)
    pre_rate = (engine.messages_processed - msgs0) / pre_s
    stalls = []
    evicted0 = arena.evicted_count
    for _ in range(40):
        drive(hot_inj, 8, stalls)
        if arena.live_count == hot and not engine.collector.active():
            break
    evicted = arena.evicted_count - evicted0
    msgs1 = engine.messages_processed
    post_s = drive(hot_inj, 16)
    post_rate = (engine.messages_processed - msgs1) / post_s
    require(evicted == n - hot, f"collection evicted {evicted}, want "
            f"{n - hot}")
    if threshold == 0.0:
        require(arena.generation == gen0, "the generation moved")
    else:
        require(arena.generation > gen0, "no compaction ran")
    # every evicted player's record is its state at eviction
    cold = keys[hot:]
    recs = store.read_many("PresenceGrain", cold.tolist())
    require(len(recs) == len(cold), "records missing")
    for field_, want in (("heartbeats", hb[hot:]), ("last_heartbeat",
                                                    last[hot:]),
                         ("game", games[hot:])):
        got = np.array([int(recs[int(k)][field_]) for k in cold])
        require(np.array_equal(got, want), f"store {field_} != oracle")
    warm_recs = store.read_many("PresenceGrain", warm.tolist())
    require(all(int(r["heartbeats"]) == 0 and int(r["game"]) == -1
                for r in warm_recs.values()) and len(warm_recs) == chunk,
            "warm records")
    # the probe re-activates with its state
    probe = int(keys[-1])
    engine.send_batch("PresenceGrain", "heartbeat",
                      np.array([probe], dtype=np.int64),
                      _presence_payload(np.zeros(1, np.int32), [probe], 0))
    asyncio.run(engine.flush())
    hb[probe] += 1
    last[probe] = 0
    games_now = games.copy()
    games_now[probe] = 0
    live_keys = np.sort(arena.keys())
    require(np.array_equal(live_keys, np.append(keys[:hot], probe)),
            "live keys != hot + probe")
    rows, _ = arena.lookup_rows(live_keys)
    state = {k: v.cpu().numpy()[rows] for k, v in arena.state.items()}
    for field_, want in (("heartbeats", hb), ("last_heartbeat", last),
                         ("game", games_now)):
        require(np.array_equal(state[field_], want[live_keys]),
                f"live {field_} != oracle")
    require(arena.restored_count == 1, f"restored {arena.restored_count}")
    # the games: every heartbeat's update, exact (integer-valued floats)
    updates = np.bincount(games, weights=hb, minlength=COLL_GAMES)
    updates[games[probe]] -= 1
    updates[0] += 1
    ga = engine.arena_for("GameGrain")
    grows, found = ga.lookup_rows(np.arange(COLL_GAMES, dtype=np.int64))
    require(found.all(), "game rows")
    require(np.array_equal(ga.state["updates"].cpu().numpy()[grows],
                           updates)
            and np.array_equal(ga.state["total_score"].cpu().numpy()[grows],
                               updates.astype(np.float32)),
            "game updates != oracle")
    # the attribution plane: retired + live counts == messages per key
    att = engine.attribution
    got = att.per_key_totals("PresenceGrain")
    want = {int(k): int(v) for k, v in zip(keys, hb) if v}
    require(got == want, "attribution totals (players) != messages")
    got = att.per_key_totals("GameGrain")
    require(got == {g: int(u) for g, u in enumerate(updates) if u},
            "attribution totals (games) != messages")
    stall = np.asarray(stalls) if stalls else np.zeros(1)
    snap = engine.collector.snapshot()
    snap.pop("last_slices")
    return {
        "evicted": evicted, "generation_moved": arena.generation != gen0,
        "max_collect_stall_s": float(stall.max()),
        "collect_stall_p99_s": float(np.percentile(stall, 99)),
        "pre_evict_msgs_per_sec": pre_rate,
        "post_evict_msgs_per_sec": post_rate,
        "collector": snap,
        "retired_keys": att.stats()["retired_keys"],
    }


def drive_collection_path(dev, card: str) -> dict:
    """Collection 500k/50k: incremental, synchronous, and across a
    threshold compaction; launches counted over the three runs."""
    from orleans_tpu_torch.kernels import _build

    gc.collect()
    _build.reset_launch_counts()
    out = {"incremental": collection_run(dev, COLL_BUDGET, 0.0),
           "synchronous": collection_run(dev, 0.0, 0.0),
           "compacting": collection_run(dev, COLL_BUDGET, 0.75)}
    out["counts"] = _build.launch_counts()
    out["report"] = _build.launch_report()
    require_launched(out["counts"], "collection", COLLECTION_KERNELS)
    for mode in ("incremental", "synchronous", "compacting"):
        r = out[mode]
        print(f"collection {mode} {COLL_GRAINS} players / {COLL_HOT} hot: "
              f"evicted {r['evicted']} (generation moved: "
              f"{r['generation_moved']}), collect stall max "
              f"{r['max_collect_stall_s'] * 1e3:.3f} ms, p99 "
              f"{r['collect_stall_p99_s'] * 1e3:.3f} ms; "
              f"{r['pre_evict_msgs_per_sec']:.1f} msgs/s before eviction, "
              f"{r['post_evict_msgs_per_sec']:.1f} after; collector "
              f"{json.dumps(r['collector'])}; on {card}", flush=True)
    print(f"launches on the collection path: {json.dumps(out['counts'])}",
          flush=True)
    return out


def drive_timers_path(dev, card: str) -> dict:
    """The 2M one-shot harvest headline, the auction sample at 1M and the
    watchdog at 500k, each exact; launches counted over the three."""
    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.samples.auction import run_auction_load
    from orleans_tpu_torch.samples.watchdog import run_watchdog_load
    from orleans_tpu_torch.tensor.engine import TensorEngine

    gc.collect()
    _build.reset_launch_counts()
    out = {}
    n = TIMERS_N
    engine = TensorEngine(device=dev, config=TensorEngineConfig(
        auto_fusion_ticks=0))
    keys = np.arange(n, dtype=np.int64)
    engine.arena_for("AuctionGrain").reserve(n)
    inj = engine.make_injector("AuctionGrain", "bid", keys)
    inj.inject({"amount": np.zeros(n, np.float32)})
    engine.run_tick()
    asyncio.run(engine.flush())
    dues = engine.tick_number + 1 + (keys % TIMERS_SPREAD)
    t0 = time.perf_counter()
    engine.timers.arm_batch("AuctionGrain", keys, dues, 0, "close")
    arm_s = time.perf_counter() - t0
    closes_at = {}
    t0 = time.perf_counter()
    for _ in range(TIMERS_SPREAD + 1):
        engine.run_tick()
        closes_at[engine.tick_number] = engine.timers.fired_total
    asyncio.run(engine.flush())
    harvest_s = time.perf_counter() - t0
    snap = engine.timers.snapshot()
    arena = engine.arena_for("AuctionGrain")
    rows, found = arena.lookup_rows(keys)
    closes = arena.state["closes"].cpu().numpy()[rows]
    per_tick = np.bincount(dues - dues.min(), minlength=TIMERS_SPREAD)
    fired_per_tick = np.diff([0] + [closes_at[t] for t in sorted(closes_at)])
    require(found.all() and (closes == 1).all(), "a closing fired twice "
            "or never")
    require(snap["fired"] == n and snap["worst_lateness_ticks"] == 0
            and snap["armed"] == 0, f"harvest {snap}")
    require(np.array_equal(fired_per_tick[:TIMERS_SPREAD], per_tick),
            "timers fired off their tick")
    out["harvest"] = {
        "fires_per_sec": n / harvest_s, "arms_per_sec": n / arm_s,
        "mean_harvest_width": snap["mean_harvest_width"],
        "worst_lateness_ticks": snap["worst_lateness_ticks"],
        "seconds": harvest_s}
    del engine, inj, arena
    gc.collect()
    engine = TensorEngine(device=dev, config=TensorEngineConfig(
        auto_fusion_ticks=0))
    t0 = time.perf_counter()
    out["auction"] = asyncio.run(run_auction_load(
        engine, n_auctions=AUCTIONS, n_ticks=40, verify=True))
    out["auction"]["seconds"] = time.perf_counter() - t0
    del engine
    gc.collect()
    engine = TensorEngine(device=dev, config=TensorEngineConfig(
        auto_fusion_ticks=0))
    t0 = time.perf_counter()
    out["watchdog"] = asyncio.run(run_watchdog_load(
        engine, n_devices=FLEET, window=8, n_windows=4, verify=True))
    out["watchdog"]["seconds"] = time.perf_counter() - t0
    del engine
    out["counts"] = _build.launch_counts()
    out["report"] = _build.launch_report()
    require_launched(out["counts"], "timers", TIMERS_KERNELS)
    h = out["harvest"]
    print(f"timers {n} one-shots over {TIMERS_SPREAD} ticks: "
          f"{h['fires_per_sec']:.1f} fires/s ({h['seconds']:.3f} s for the "
          f"ticks), armed at {h['arms_per_sec']:.1f}/s, mean harvest width "
          f"{h['mean_harvest_width']}, worst lateness "
          f"{h['worst_lateness_ticks']}; auction {AUCTIONS}: "
          f"{json.dumps(out['auction'])}; watchdog {FLEET}: "
          f"{json.dumps(out['watchdog'])}; on {card}", flush=True)
    print(f"launches on the timers path: {json.dumps(out['counts'])}",
          flush=True)
    return out


def drive_composition_path(dev, card: str) -> dict:
    """The watchdog at 50,000 devices with collection on: silent devices
    are evicted between watches and each watch fire re-activates them
    through the store.  The oracle is the same run on the CPU engine,
    compared key by key, with the timer mirrors and the counters."""
    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.samples.watchdog import run_watchdog_load
    from orleans_tpu_torch.tensor.engine import TensorEngine
    from orleans_tpu_torch.tensor.persistence import MemoryVectorStore

    def run(device):
        engine = TensorEngine(device=device, store=MemoryVectorStore(),
                              config=TensorEngineConfig(
                                  auto_fusion_ticks=0,
                                  collection_idle_ticks=4,
                                  collection_every_ticks=2))
        stats = asyncio.run(run_watchdog_load(
            engine, n_devices=COMPOSED_FLEET, window=8, n_windows=4,
            verify=False))
        return engine, stats

    gc.collect()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    eng, stats = run(dev)
    seconds = time.perf_counter() - t0
    counts = _build.launch_counts()
    report = _build.launch_report()
    ref, ref_stats = run("cpu")
    require(stats == ref_stats, f"composition stats {stats} != CPU "
            f"{ref_stats}")
    a, b = eng.arena_for("FleetDeviceGrain"), ref.arena_for(
        "FleetDeviceGrain")
    keys = np.arange(COMPOSED_FLEET, dtype=np.int64)
    ra, fa = a.lookup_rows(keys)
    rb, fb = b.lookup_rows(keys)
    require(fa.all() and fb.all(), "composition: a device is not live")
    for name, col in a.state.items():
        require(np.array_equal(col.cpu().numpy()[ra],
                               b.state[name].numpy()[rb]),
                f"composition {name} != CPU engine")
    for k in ("evicted", "restored", "messages", "ticks",
              "activation_passes"):
        require(eng.stats()[k] == ref.stats()[k], f"composition {k}")
    ta, tb = eng.timers.snapshot(), ref.timers.snapshot()
    ta.pop("harvest_seconds")
    tb.pop("harvest_seconds")
    require(ta == tb, f"composition timers {ta} != {tb}")
    tt_a = eng.timers._types["FleetDeviceGrain"]
    tt_b = ref.timers._types["FleetDeviceGrain"]
    require(np.array_equal(tt_a.due_np, tt_b.due_np)
            and np.array_equal(tt_a.key.cpu().numpy(), tt_b.key.numpy())
            and np.array_equal(tt_a.due.cpu().numpy(), tt_b.due.numpy()),
            "composition timer columns")
    st = eng.stats()
    require(st["evicted"] > 0 and st["restored"] > 0,
            "composition evicted or restored nothing")
    require_launched(counts, "composition", COMPOSED_KERNELS)
    print(f"watchdog {COMPOSED_FLEET} with collection: {json.dumps(stats)}, "
          f"evicted {st['evicted']}, restored {st['restored']}, "
          f"{seconds:.3f} s; equal to the CPU engine key by key; launches "
          f"{json.dumps(counts)}; on {card}", flush=True)
    return {"counts": counts, "report": report, "stats": stats,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 9: the device streams plane
# ---------------------------------------------------------------------------

def _chat_engine(dev, fuse: bool = False, store=None):
    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.tensor.engine import TensorEngine

    return TensorEngine(device=dev, store=store, config=TensorEngineConfig(
        auto_fusion_ticks=16 if fuse else 0))


def _row_float_tol(values: torch.Tensor, offsets: torch.Tensor
                   ) -> torch.Tensor:
    """Per row, ``2 * k * 2**-24 * sum|x|`` over its ``k`` lanes: the
    kernel sums a row in float32 in lane order, the plain version in
    float64 rounded once."""
    from orleans_tpu_torch.kernels import pull as kpull

    k = (offsets[1:] - offsets[:-1]).double()
    mag = kpull.seg_pull_plain(values.abs(), offsets, "sum").double()
    return 2 * k * 2.0**-24 * mag


def check_pull_kernels(dev, timer, card: str, pull: dict) -> dict:
    """K16 and K17 against their plain versions on the card, on the chat
    headline's pull layout (``pull``: 1,000,000 users, 4,096 rooms, 1.5
    memberships): int32 sums of the checksum lanes and of a batch whose
    running total crosses 2**31 (and one of full-range values whose row
    sums wrap), an int32 max with ``fill=-1`` over masked lanes and empty
    rows, a float32 sum within the stated per-row bound, the count mode
    with a slot total, and K17.  Each mode timed beside its bound, its
    plain version and a library yardstick where one PyTorch call computes
    the same function."""
    from orleans_tpu_torch.kernels import pull as kpull

    rng = np.random.default_rng(1357)
    offs, lane = pull["offsets"], pull["src_lane"]
    m, n_rows = pull["n_edges"], offs.shape[0] - 1

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    msg = torch.arange(CHAT_ROOMS, dtype=torch.int32, device=dev) \
        + 7 * CHAT_ROOMS
    msg_e = msg.index_select(0, lane)
    mix = msg_e % 1009 + pull["src_key"] % 97       # the checksum lanes
    # lanes averaging 2**32 / m: the running total reaches about 2**32
    wrapping = t(rng.integers(0, min(2**31 - 1, 2**33 // m), m)
                 .astype(np.int32))
    full = t(rng.integers(-2**31, 2**31, m, dtype=np.int64)
             .astype(np.int32))
    require(int(wrapping.long().sum()) > 2**31, "the wrapping batch's "
            "total stays below 2**31")
    for what, v in (("checksum lanes", mix), ("running total past 2**31",
                                              wrapping),
                    ("full-range values", full)):
        require(torch.equal(kpull.seg_pull(v, offs, "sum"),
                            kpull.seg_pull_plain(v, offs, "sum")),
                f"seg_pull sum != plain ({what})")
    masked = torch.where(t(rng.random(m) < 0.9), msg_e, -1)
    got_max = kpull.seg_pull(masked, offs, "max", fill=-1)
    require(torch.equal(got_max, kpull.seg_pull_plain(masked, offs, "max",
                                                      fill=-1)),
            "seg_pull max != plain")
    empty = offs[1:] == offs[:-1]
    require(bool(empty.any()) and bool((got_max[empty] == -1).all()),
            "empty rows must read the fill")
    floats = t((rng.standard_normal(m) * 100).astype(np.float32))
    got_f = kpull.seg_pull(floats, offs, "sum")
    want_f = kpull.seg_pull_plain(floats, offs, "sum")
    err = (got_f.double() - want_f.double()).abs()
    require(bool((err <= _row_float_tol(floats, offs)).all()),
            "seg_pull float32 sum outside the per-row bound")
    valid = t(rng.random(m) < 0.8)
    counts0 = t(rng.integers(0, 1000, n_rows).astype(np.int32))
    c1, c2 = counts0.clone(), counts0.clone()
    s1 = torch.zeros(64, dtype=torch.int32, device=dev)
    s2 = s1.clone()
    kpull.seg_pull(valid, offs, "sum", out=c1, slots=s1, slot=5)
    kpull.seg_pull_plain(valid, offs, "sum", out=c2, slots=s2, slot=5)
    require(torch.equal(c1, c2) and torch.equal(s1, s2)
            and int(s1[5]) == int(valid.sum()),
            "seg_pull count mode != plain")
    clock = t(rng.integers(0, 50, n_rows).astype(np.int32))
    k1, k2 = clock.clone(), clock.clone()
    kpull.touch_dense(k1, offs, 77)
    kpull.touch_dense_plain(k2, offs, 77)
    require(torch.equal(k1, k2), "touch_dense != plain")

    offs64 = offs.long()
    lib = {}
    for name_, v in (("int32", mix), ("float32", floats)):
        try:
            torch.segment_reduce(v, "sum", offsets=offs64, unsafe=True)
            lib[name_] = v
        except (RuntimeError, NotImplementedError) as exc:
            lib[name_] = exc

    def library(v, reduce="sum", **kw):
        return lambda: torch.segment_reduce(v, reduce, offsets=offs64,
                                            unsafe=True, **kw)

    def cumsum_diff():
        z = torch.cumsum(mix, 0, dtype=torch.int32)
        hi = z.index_select(0, (offs64[1:] - 1).clamp(min=0))
        lo = z.index_select(0, (offs64[:-1] - 1).clamp(min=0))
        return hi - lo

    seg_bytes = 4 * m + 4 * (n_rows + 1) + 4 * n_rows
    modes = {
        "sum_int32": dict(bound=bound(seg_bytes), **measure(
            timer, lambda: kpull.seg_pull(mix, offs, "sum"),
            lambda: kpull.seg_pull_plain(mix, offs, "sum"),
            library(mix) if isinstance(lib["int32"], torch.Tensor)
            else None)),
        "max_int32": dict(bound=bound(seg_bytes), **measure(
            timer, lambda: kpull.seg_pull(masked, offs, "max", fill=-1),
            lambda: kpull.seg_pull_plain(masked, offs, "max", fill=-1),
            library(masked, "max", initial=-1)
            if isinstance(lib["int32"], torch.Tensor) else None)),
        "sum_float32": dict(bound=bound(seg_bytes), **measure(
            timer, lambda: kpull.seg_pull(floats, offs, "sum"),
            lambda: kpull.seg_pull_plain(floats, offs, "sum"),
            library(floats) if isinstance(lib["float32"], torch.Tensor)
            else None)),
        "count_slot": dict(
            bound=bound(m + 4 * (n_rows + 1) + 8 * n_rows + 8), **measure(
                timer, lambda: kpull.seg_pull(valid, offs, "sum", out=c1,
                                              slots=s1, slot=5),
                lambda: kpull.seg_pull_plain(valid, offs, "sum", out=c2,
                                             slots=s2, slot=5), None)),
    }
    composite_ms = timer(cumsum_diff)
    head = modes["sum_int32"]
    int_note = ("torch.segment_reduce on the int32 lanes" if head[
        "library_ms"] is not None else
        f"no single PyTorch call: torch.segment_reduce refused int32 "
        f"({lib['int32']}); cumsum(dtype=int32) + two index_select + a "
        f"subtraction take {composite_ms:.4f} ms")
    results = {"seg_pull": dict(
        max_abs_err=float(err.max()), library=int_note,
        bound=head["bound"], ms=head["ms"], host_ms=head["host_ms"],
        plain_ms=head["plain_ms"], library_ms=head["library_ms"],
        per={k: {kk: (vv if kk != "bound" else list(vv))
                 for kk, vv in v.items()} for k, v in modes.items()},
        composite_ms=composite_ms)}
    results["seg_pull"]["per"]["sum_int32"]["library_note"] = int_note
    results["touch_dense"] = dict(
        max_abs_err=0, library=None,
        library_note="no single PyTorch call: the shortest expression is "
                     "the plain version, maximum(last_use, where(offsets[1:]"
                     " > offsets[:-1], tick, 0)), timed as plain_ms",
        bound=bound(4 * (n_rows + 1) + 8 * n_rows),
        **measure(timer, lambda: kpull.touch_dense(k1, offs, 78),
                  lambda: kpull.touch_dense_plain(k2, offs, 78), None))
    for key, v in modes.items():
        lib_ms = f"{v['library_ms']:.4f}" if v["library_ms"] is not None \
            else "none"
        print(f"kernel seg_pull {key}: {v['ms']:.4f} ms on the device, host "
              f"{v['host_ms']:.4f} (plain {v['plain_ms']:.4f}, library "
              f"{lib_ms}, bound {v['bound'][0]:.4f} by {v['bound'][1]}); "
              f"{m} lanes, {n_rows} rows; on {card}", flush=True)
    v = results["touch_dense"]
    print(f"kernel touch_dense: {v['ms']:.4f} ms on the device, host "
          f"{v['host_ms']:.4f} (plain {v['plain_ms']:.4f}, bound "
          f"{v['bound'][0]:.4f} by {v['bound'][1]}); int32 cumsum "
          f"composite {composite_ms:.4f} ms; float32 max |kernel - plain| "
          f"{float(err.max()):.3e}; on {card}", flush=True)
    return results


def chat_replay(subs, n_users: int, n_windows: int, window: int) -> dict:
    """The expected member columns after ``run_chat_load_fused``: every
    window ``b`` (0 the warm one) delivers message ``(t + b) * rooms +
    room`` of each tick ``t`` over ``host_expand`` (a numpy replay of the
    stacked message ids)."""
    rooms = np.arange(CHAT_ROOMS, dtype=np.int64)
    dsts, srcs = subs.host_expand(rooms)
    steps = (np.arange(window)[:, None]
             + np.arange(n_windows + 1)[None, :]).reshape(-1)
    msgs = steps[None, :] * CHAT_ROOMS + rooms[:, None]     # [rooms, k]
    per_room = (msgs % 1009).sum(axis=1) + len(steps) * (rooms % 97)
    received = np.zeros(n_users, np.int64)
    last = np.full(n_users, -1, np.int64)
    checksum = np.zeros(n_users, np.int64)
    np.add.at(received, dsts, len(steps))
    np.maximum.at(last, dsts, msgs.max(axis=1)[srcs])
    np.add.at(checksum, dsts, per_room[srcs])
    return {"received": received, "last_msg": last, "checksum": checksum}


def check_members(engine, want: dict, n_users: int) -> None:
    arena = engine.arena_for("ChatUserGrain")
    rows, ok = arena.lookup_rows(np.arange(n_users, dtype=np.int64))
    require(ok.all(), "a chat member is not live")
    for name, col in want.items():
        got = arena.state[name].cpu().numpy()[rows]
        require(np.array_equal(got, col), f"fused chat {name} != the numpy "
                f"replay ({int((got != col).sum())} members differ)")


def streams_churn(dev) -> dict:
    """bench.py ``_streams_churn_exactness`` at its full size (100,000
    users, 256 rooms, 2.0 memberships): exact after subscribe, after
    unsubscribe, after evicting 10% of the members through a
    ``MemoryVectorStore`` and reusing their rows with fresh keys (the
    reused rows must be clean), with the plane switched off (the host
    path) and back on."""
    from orleans_tpu_torch.samples.streams import (
        _HostMirror,
        build_membership,
        run_chat_load,
    )
    from orleans_tpu_torch.tensor.persistence import MemoryVectorStore
    from orleans_tpu_torch.tensor.streams_plane import DeviceSubscriptions

    n_users, n_rooms = CHURN_USERS, CHURN_ROOMS
    engine = _chat_engine(dev, store=MemoryVectorStore())
    subs = DeviceSubscriptions(engine, "ChatUserGrain", "receive")
    subs.subscribe_many(*build_membership(n_rooms, n_users, CHURN_MEAN,
                                          seed=7))
    mirror = _HostMirror(subs, n_users)
    points = {}
    rng = np.random.default_rng(7)

    def publish_and_check(tag: str) -> None:
        st = asyncio.run(run_chat_load(
            engine, n_rooms=n_rooms, n_users=n_users, n_ticks=3,
            seed=len(points) + 1, subs=subs, verify=True, mirror=mirror))
        points[tag] = st["oracle"]
        require(all(v for k, v in st["oracle"].items()
                    if k.endswith("_exact")), f"churn {tag}: {st['oracle']}")

    publish_and_check("subscribe")
    subs.subscribe_many(*build_membership(n_rooms, n_users, 0.5, seed=11))
    drop = subs.subscribers_of(3)
    subs.unsubscribe_many(np.full(len(drop) // 2, 3), drop[:len(drop) // 2])
    publish_and_check("unsubscribe")
    arena = engine.arena_for("ChatUserGrain")
    victims = rng.choice(n_users, n_users // 10, replace=False) \
        .astype(np.int64)
    arena.evict_keys(victims, write_back=True)
    mirror.evict_keys(victims)
    fresh = np.arange(n_users, n_users + len(victims), dtype=np.int64)
    arena.resolve_rows(fresh)
    publish_and_check("evict_and_reuse")
    rows, ok = arena.lookup_rows(fresh)
    require(ok.all() and not arena.state["received"].cpu().numpy()[
        rows].any(), "a reused row received a dead subscription's events")
    engine.config.stream_plane = False
    publish_and_check("plane_disabled_host_path")
    engine.config.stream_plane = True
    publish_and_check("plane_reenabled")
    return {"points": points, "evicted": int(len(victims)),
            "plane": engine.stats()["streams"]}


def drive_streams_path(dev, card: str, timer) -> dict:
    """Phase 9: the streams plane at the JAX bench's full size: K16/K17
    against their plain versions on the chat layout; chat unfused
    (1,000,000 users, 4,096 rooms, 1.5 memberships, 8 ticks, oracle on)
    with its timings; the fused chat headline (96 ticks, windows of 16)
    against a numpy replay, with a window's device time and the idle
    share; leaderboards (512 boards, 1,000,000 members, 24 ticks, oracle
    on); the churn exactness at 100,000 users.  Launches counted per
    path."""
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.samples.streams import (
        run_chat_load,
        run_chat_load_fused,
        run_leaderboard_load,
        wire_chat,
    )

    out = {"counts": {}, "report": {}}
    gc.collect()
    t0 = time.perf_counter()
    engine = _chat_engine(dev)
    subs = wire_chat(engine, CHAT_ROOMS, CHAT_USERS, CHAT_MEAN, seed=0)
    pull = subs.pull_layout(engine.arena_for("ChatUserGrain"))
    require(pull is not None, "the chat layout is cold")
    edges, lanes = subs.edge_count, pull["n_edges"]
    require(lanes == edges, f"{edges} edges but {lanes} pull lanes")
    wire_s = time.perf_counter() - t0
    out["kernels"] = check_pull_kernels(dev, timer, card, pull)
    del pull

    # chat unfused, oracle on
    _build.reset_launch_counts()
    st = asyncio.run(run_chat_load(engine, n_rooms=CHAT_ROOMS,
                                   n_users=CHAT_USERS,
                                   mean_memberships=CHAT_MEAN,
                                   n_ticks=CHAT_TICKS, subs=subs,
                                   verify=True))
    require(all(v for k, v in st["oracle"].items() if k.endswith("_exact")),
            f"chat unfused oracle {st['oracle']}")
    require(subs.pull_deliveries == CHAT_TICKS and subs.push_deliveries == 0,
            f"chat unfused took {subs.pull_deliveries} pull and "
            f"{subs.push_deliveries} push deliveries")
    out["counts"]["chat_unfused"] = _build.launch_counts()
    out["report"]["chat_unfused"] = _build.launch_report()
    require_launched(out["counts"]["chat_unfused"], "chat unfused",
                     STREAMS_UNFUSED_KERNELS)
    events_per_tick = CHAT_ROOMS + edges
    msg_d = torch.arange(CHAT_ROOMS, dtype=torch.int32, device=dev)
    inj = engine.make_injector("ChatRoomGrain", "publish",
                               np.arange(CHAT_ROOMS, dtype=np.int64))
    run = LoadRun(engine, inj, lambda t: {"msg_id": msg_d + 100_000 + t})
    timings = path_timings(run, events_per_tick, TICKS)
    require(subs.push_deliveries == 0, "a timed chat tick went push")
    out["unfused"] = dict(oracle=st["oracle"], seconds=st["seconds"],
                          edges=edges, wire_s=wire_s, **timings)
    del run, inj, engine, subs
    gc.collect()

    # chat fused: the headline
    _build.reset_launch_counts()
    engine = _chat_engine(dev, fuse=True)
    t0 = time.perf_counter()
    fused = asyncio.run(run_chat_load_fused(
        engine, n_rooms=CHAT_ROOMS, n_users=CHAT_USERS,
        mean_memberships=CHAT_MEAN, n_ticks=CHAT_FUSED_TICKS, window=16))
    fused_total_s = time.perf_counter() - t0
    out["counts"]["chat_fused"] = _build.launch_counts()
    out["report"]["chat_fused"] = _build.launch_report()
    require_launched(out["counts"]["chat_fused"], "chat fused",
                     STREAMS_FUSED_KERNELS)
    require(out["report"]["chat_fused"]["seg_pull"]["replayed"] > 0,
            "seg_pull never replayed")
    subs = engine._stream_routes[("ChatRoomGrain", "publish")]
    check_members(engine, chat_replay(subs, CHAT_USERS,
                                      CHAT_FUSED_TICKS // 16, 16),
                  CHAT_USERS)
    # a window's device time and the idle share of pipelined windows
    rooms = np.arange(CHAT_ROOMS, dtype=np.int64)
    prog = engine.fuse_ticks("ChatRoomGrain", "publish", rooms)
    base = torch.arange(16, dtype=torch.int32, device=dev)[:, None] \
        * CHAT_ROOMS + msg_d[None]
    stacked = {"msg_id": base}
    prog.run(stacked)  # the build
    engine.wait_completion()
    dev_ms, host_ms = held_device_ms(lambda: prog.run(stacked), reps=3)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    engine.wait_completion()
    ev[0].record()
    for _ in range(6):
        prog.run(stacked)
    ev[1].record()
    ev[1].synchronize()
    stream_ms = ev[0].elapsed_time(ev[1])
    require(prog.verify() == 0, "a timed chat window missed deliveries")
    out["fused"] = dict(fused, window_device_ms=dev_ms,
                        window_host_ms=host_ms, total_s=fused_total_s,
                        idle_share=1 - 6 * dev_ms / stream_ms,
                        stream_ms_6_windows=stream_ms,
                        per_replay=dict(prog._per_replay),
                        rebuilds=dict(prog.rebuilds))
    out["caps"] = {n: engine.arena_for(n).capacity
                   for n in ("ChatRoomGrain", "ChatUserGrain")}
    out["caps"]["edges"] = edges
    del prog, engine, subs, stacked, base
    gc.collect()

    # leaderboards, unfused, oracle on
    _build.reset_launch_counts()
    engine = _chat_engine(dev)
    t0 = time.perf_counter()
    boards = asyncio.run(run_leaderboard_load(
        engine, n_boards=BOARDS, n_members=BOARD_MEMBERS,
        mean_follows=BOARD_MEAN, n_ticks=BOARD_TICKS, verify=True))
    boards["total_s"] = time.perf_counter() - t0
    require(all(v for k, v in boards["oracle"].items()
                if k.endswith("_exact")), f"leaderboards {boards['oracle']}")
    route = engine.stats()["streams"]["LeaderboardGrain.post"]
    require(route["pull_deliveries"] == BOARD_TICKS
            and route["push_deliveries"] == 0, f"leaderboards {route}")
    out["counts"]["leaderboards"] = _build.launch_counts()
    out["report"]["leaderboards"] = _build.launch_report()
    require_launched(out["counts"]["leaderboards"], "leaderboards",
                     STREAMS_UNFUSED_KERNELS)
    out["leaderboards"] = boards
    del engine
    gc.collect()

    # churn exactness
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out["churn"] = streams_churn(dev)
    out["churn"]["seconds"] = time.perf_counter() - t0
    out["counts"]["streams_churn"] = _build.launch_counts()
    out["report"]["streams_churn"] = _build.launch_report()
    require_launched(out["counts"]["streams_churn"], "streams churn",
                     STREAMS_CHURN_KERNELS)

    u, f = out["unfused"], out["fused"]
    print(f"chat unfused {CHAT_USERS} users / {CHAT_ROOMS} rooms / "
          f"{edges} edges: oracle {json.dumps(u['oracle'])} over "
          f"{CHAT_TICKS} ticks ({u['seconds']:.3f} s with the numpy "
          f"oracle); {u['messages_per_sec']:.1f} events/s pipelined over "
          f"{TICKS} ticks, one tick {u['tick_device_ms']:.4f} ms on the "
          f"device, {u['tick_host_ms']:.4f} ms on the host; wiring "
          f"{u['wire_s']:.2f} s; on {card}", flush=True)
    print(f"chat fused {CHAT_FUSED_TICKS} ticks in windows of 16: "
          f"{f['events_per_sec']:.1f} events/s ({f['seconds']:.4f} s for "
          f"the windows after the warm one, verify() == 0, members equal "
          f"the numpy replay); one window {f['window_device_ms']:.4f} ms on "
          f"the device, {f['window_host_ms']:.4f} ms on the host; idle "
          f"share over 6 pipelined windows {f['idle_share']:.4f}; one "
          f"replay = {json.dumps(f['per_replay'])}; on {card}", flush=True)
    print(f"leaderboards {BOARDS} boards / {BOARD_MEMBERS} members / "
          f"{boards['edges']} edges, {BOARD_TICKS} ticks: oracle "
          f"{json.dumps(boards['oracle'])}, {boards['events_per_sec']:.1f} "
          f"events/s with the numpy oracle; streams churn "
          f"{CHURN_USERS} users / {CHURN_ROOMS} rooms: every point exact "
          f"({', '.join(out['churn']['points'])}), "
          f"{out['churn']['evicted']} evicted, {out['churn']['seconds']:.2f}"
          f" s; plane {json.dumps(out['churn']['plane'])}; on {card}",
          flush=True)
    for path, c in out["counts"].items():
        print(f"launches on the {path} path: {json.dumps(c)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 10: hot-grain replicas (K18), GPSTracker, TwitterSentiment
# ---------------------------------------------------------------------------

def _route_engine(dev):
    """A routing engine at the default config (ledger and attribution
    plane on), auto-fusion off (the fused windows are driven by hand)."""
    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.samples import routing  # noqa: F401
    from orleans_tpu_torch.tensor.engine import TensorEngine

    return TensorEngine(device=dev, config=TensorEngineConfig(
        auto_fusion_ticks=0))


def check_replica_kernels(dev, timer, card: str) -> dict:
    """K18 against its plain version and the arena's host twin, bit for
    bit: 1,048,576 lanes (a quarter aimed at the primaries, 5% misses,
    the rest other sink rows) over G = 1, 3 and 9 groups (the mirror
    padded to 1, 4 and 16) of k = 2 and 8 rows promoted on a RouteSink
    arena on the card; then, at G = 1 and k = 8, the hot-grain path's own
    rows (every lane aimed at the one primary), which are also what is
    timed, beside the bound, the plain version and the composite of
    ``torch.searchsorted`` + ``index_select`` + ``torch.where`` (no single
    PyTorch call computes it)."""
    from orleans_tpu_torch.kernels import replicas as krep
    from orleans_tpu_torch.samples import routing

    rng = np.random.default_rng(18)
    sinks = routing.sink_keys(HOT_SINKS)
    m = SPREAD_LANES
    timed = None
    for n_groups in (1, 3, 9):
        for k in (2, 8):
            eng = _route_engine(dev)
            arena = eng.arena_for("RouteSink")
            arena.reserve(HOT_SINKS)
            arena.resolve_rows(sinks)
            hot = rng.choice(sinks, n_groups, replace=False)
            for key in hot.tolist():
                require(eng.replicate_key("RouteSink", key, k) == k,
                        f"promote to {k}")
            prim_rows = arena.lookup_rows(hot)[0]
            rows = rng.integers(0, HOT_SINKS, m).astype(np.int32)
            aim = rng.random(m) < 0.25
            rows[aim] = prim_rows[rng.integers(0, n_groups, aim.sum())]
            rows[rng.random(m) < 0.05] = -1
            mirror = arena.replica_mirror()
            rows_d = torch.from_numpy(rows).to(dev)
            got = krep.spread_replicas(*mirror, rows_d)
            want = krep.spread_replicas_plain(*mirror, rows_d)
            require(torch.equal(got, want),
                    f"spread_replicas != plain (G={n_groups}, k={k})")
            require(np.array_equal(got.cpu().numpy(),
                                   arena.spread_rows_host(rows)),
                    f"spread_replicas != spread_rows_host (G={n_groups}, "
                    f"k={k})")
            require(int((got != rows_d).sum()) > 0,
                    "the spread moved no lane")
            if n_groups == 1 and k == 8:
                # the hot-grain path's rows: every lane hits the primary
                rows_d = torch.full((m,), int(prim_rows[0]),
                                    dtype=torch.int32, device=dev)
                got = krep.spread_replicas(*mirror, rows_d)
                require(torch.equal(
                    got, krep.spread_replicas_plain(*mirror, rows_d)),
                    "spread_replicas != plain (every lane hot)")
                require(np.array_equal(got.cpu().numpy(),
                                       arena.spread_rows_host(
                                           rows_d.cpu().numpy())),
                        "spread_replicas != spread_rows_host (every lane "
                        "hot)")
                require(int(torch.unique(got).numel()) == k,
                        "the hot lanes did not reach all k rows")
                timed = (mirror, rows_d, got)
            del eng, arena
    (prim, counts, table), rows_d, got = timed
    lanes = torch.arange(m, dtype=torch.int64, device=dev)
    flat = table.reshape(-1)
    width = table.shape[1]

    def composite():
        idx = torch.searchsorted(prim, rows_d).clamp_(max=prim.shape[0] - 1)
        hit = (prim.index_select(0, idx) == rows_d) & (rows_d >= 0)
        choice = (((lanes * krep.LANE_HASH) & 0xFFFFFFFF) >> 8) \
            % counts.index_select(0, idx)
        alt = flat.index_select(0, idx * width + choice)
        return torch.where(hit & (alt >= 0), alt, rows_d)

    require(torch.equal(composite(), got), "the composite != K18")
    r = dict(bound=bound(8 * m), **measure(
        timer, lambda: krep.spread_replicas(prim, counts, table, rows_d),
        lambda: krep.spread_replicas_plain(prim, counts, table, rows_d),
        None))
    r["composite_ms"] = timer(composite)
    note = (f"no single PyTorch call: torch.searchsorted + index_select + "
            f"torch.where (the lane hash between) take "
            f"{r['composite_ms']:.4f} ms")
    r.update(max_abs_err=0, library=None, library_note=note)
    print(f"kernel spread_replicas: {r['ms']:.4f} ms on the device, host "
          f"{r['host_ms']:.4f} (plain {r['plain_ms']:.4f}, composite "
          f"{r['composite_ms']:.4f}, bound {r['bound'][0]:.4f} by "
          f"{r['bound'][1]}); {m} lanes all on the primary, G = 1, k = 8; "
          f"bit-exact against "
          f"the plain version and spread_rows_host at G = 1, 3, 9 and "
          f"k = 2, 8; on {card}", flush=True)
    return {"spread_replicas": r}


def _sink_folds(engine, sinks: np.ndarray):
    """(received int64, total float64) per sink key: the state columns
    read once, a replicated sink through ``read_row``'s fold."""
    arena = engine.arena_for("RouteSink")
    rows, found = arena.lookup_rows(sinks)
    require(bool(found.all()), "sinks live")
    recv = arena.state["received"].cpu().numpy()[rows].astype(np.int64)
    total = arena.state["total"].cpu().numpy()[rows].astype(np.float64)
    for key in list(arena._replicas):
        i = int(np.searchsorted(sinks, key))
        fold = arena.read_row(key)
        recv[i], total[i] = int(fold["received"]), float(fold["total"])
    return recv, total


def _check_sinks(engine, sinks, want_recv, want_total, depth: int,
                 what: str) -> None:
    """``received`` equal to ``expected_sink_state`` through the fold;
    ``total`` within ``2 * d * 2**-24 * sum|x|`` of it, d the depth of
    float32 additions into a sink: ``depth`` (one per tick, plus k per
    demote) and the k rows of a live group's fold.  A tick's sum into one
    row is exact (integer values, below 2**24 in all), so rounding enters
    only there.  Higham's bound over the n lanes summed would be no check
    here: at the hot sink n * 2**-24 passes 1."""
    recv, total = _sink_folds(engine, sinks)
    require(np.array_equal(recv, want_recv),
            f"{what}: received != expected_sink_state")
    groups = engine.arena_for("RouteSink")._replicas
    d = depth + max((len(g) for g in groups.values()), default=0)
    err = np.abs(total - want_total)
    require(bool(np.all(err <= 2 * d * 2.0**-24 * want_total)),
            f"{what}: total beyond 2 d 2**-24 sum|x|, d = {d} (max err "
            f"{float(err.max())})")


def _demote_checked(engine, hot: int) -> int:
    """Demote the hot sink and hold its one row to the fold it had;
    returns the group's k (the additions the fold took)."""
    arena = engine.arena_for("RouteSink")
    k = len(arena._replicas[hot])
    fold = arena.read_row(hot)
    require(engine.demote_key("RouteSink", hot) > 0, "demote freed nothing")
    row = int(arena.lookup_rows(np.array([hot], np.int64))[0][0])
    for col in ("received", "total"):
        require(arena.state[col][row].item() == fold[col].item(),
                f"the demoted sink's row != its fold ({col})")
    return k


def drive_hot_grain_path(dev, card: str) -> dict:
    """The routing sample at ``_single_hot_grain_tier``'s shape, 1,048,576
    sources and 256 sinks, ledger and attribution plane on.  Five
    unfused arms (uniform; every source to one sink, unreplicated, at
    k = 2 and at k = 8; uniform through the live k = 8 group), then the
    uniform pair again in turn (demoted, re-promoted), each 3 warm ticks,
    20 timed ticks and the held timing's blocks; then 4 fused windows of
    16 at k = 8 with a demote before window 3 and a re-promote before
    window 4, each a graph rebuild, and 7 more timed windows.
    ``received`` exact and ``total`` within its bound after every arm and
    every change."""
    from orleans_tpu_torch.kernels import _build, segment
    from orleans_tpu_torch.samples import routing
    from orleans_tpu_torch.tensor.fused import CAUSE_REPLICA_CHANGE

    sources = np.arange(HOT_SOURCES, dtype=np.int64)
    sinks = routing.sink_keys(HOT_SINKS)
    uniform = routing.build_ratio_destinations(sources, sinks, 1, 0.0,
                                               seed=3)
    hot = int(sinks[0])
    hot_dst = np.full(HOT_SOURCES, hot, np.int64)
    values = np.random.default_rng(20260806).integers(
        1, 8, HOT_SOURCES).astype(np.float32)
    values_d = torch.from_numpy(values).to(dev)
    eng = _route_engine(dev)
    eng.arena_for("RouteSource").reserve(HOT_SOURCES)
    eng.arena_for("RouteSink").reserve(HOT_SINKS)
    eng.arena_for("RouteSource").resolve_rows(sources)
    eng.arena_for("RouteSink").resolve_rows(sinks)
    sink_arena = eng.arena_for("RouteSink")
    inj = eng.make_injector("RouteSource", "send", sources)
    want_recv = np.zeros(HOT_SINKS, np.int64)
    want_total = np.zeros(HOT_SINKS, np.float64)
    # float32 additions into a sink row: one a tick (the tick's own sum,
    # up to 7 * 2**20, is exact) and k for each demote's fold
    require(float(values.sum()) < 2**24, "a tick's hot-sink sum inexact")
    depth = [0]

    def expect(dst, n_ticks):
        t, r = routing.expected_sink_state(sources, dst, values, sinks,
                                           n_ticks)
        want_total[:] += t
        want_recv[:] += r
        depth[0] += n_ticks

    def check(what: str) -> None:
        _check_sinks(eng, sinks, want_recv, want_total, depth[0], what)

    def demote() -> None:
        depth[0] += _demote_checked(eng, hot)

    out = {"counts": {}, "report": {}, "arms": {}}
    arm_rows = {}
    # the last two arms repeat the uniform pair in turn (demoted, then
    # k = 8 again), so the spread's cost is read beside its neighbour
    # and apart from the arm's place in the run
    arms = (("uniform", uniform, None), ("hot", hot_dst, None),
            ("hot_k2", hot_dst, 2), ("hot_k8", hot_dst, 8),
            ("uniform_k8", uniform, None), ("uniform_again", uniform, 1),
            ("uniform_k8_again", uniform, 8))
    gc.collect()
    _build.reset_launch_counts()
    for name, dst, k in arms:
        if k == 1:
            demote()
            check("after the demote from k = 8")
        if k == 2:
            require(eng.replicate_key("RouteSink", hot, 2) == 2, "k = 2")
        if k == 8:
            if sink_arena._replicas:
                demote()
                check("after the demote from k = 2")
            require(eng.replicate_key("RouteSink", hot, 8) == 8, "k = 8")
        dst_d = torch.from_numpy(dst.astype(np.int32)).to(dev)
        c0 = _build.launch_counts()
        run = LoadRun(eng, inj, lambda t, d=dst_d: {
            "dst": d, "v": values_d, "tick": np.int32(t)})
        timings = path_timings(run, 2 * HOT_SOURCES, HOT_TICKS)
        c1 = _build.launch_counts()
        expect(dst, run.ticks)
        check(f"arm {name}")
        group = sink_arena._replicas.get(hot)
        arm_rows[name] = sink_arena.spread_rows_host(
            sink_arena.lookup_rows(dst)[0])
        a = out["arms"][name] = dict(
            timings, ticks=run.ticks,
            k=1 if group is None else len(group),
            spread_launches=c1["spread_replicas"] - c0["spread_replicas"])
        require((a["spread_launches"] > 0) == (group is not None),
                f"arm {name}: K18 launched {a['spread_launches']} times")
    out["counts"]["hot_grain_unfused"] = _build.launch_counts()
    out["report"]["hot_grain_unfused"] = _build.launch_report()
    require_launched(out["counts"]["hot_grain_unfused"], "hot-grain unfused",
                     ROUTING_HOT_KERNELS)

    # fused: 4 windows of 16 at k = 8, a demote before window 3, a
    # re-promote before window 4
    _build.reset_launch_counts()
    prog = eng.fuse_ticks("RouteSource", "send", sources)
    static = {"dst": torch.from_numpy(hot_dst.astype(np.int32)).to(dev),
              "v": values_d}
    ticks_d = torch.arange(16, dtype=torch.int32, device=dev)
    fused = {"ticks": 0, "counted": 0}

    def window():
        prog.run({"tick": ticks_d + fused["ticks"]}, static_args=static)
        fused["ticks"] += 16

    def settle(what: str) -> None:
        eng.wait_completion()
        require(prog.verify() == 0, f"{what}: a window missed deliveries")
        expect(hot_dst, fused["ticks"] - fused["counted"])
        fused["counted"] = fused["ticks"]
        check(what)

    rebuilds = []
    for w in range(HOT_WINDOWS):
        if w == 2:
            settle("fused windows 1-2 at k = 8")
            demote()
        if w == 3:
            require(eng.replicate_key("RouteSink", hot, 8) == 8, "k = 8")
        window()
        rebuilds.append(dict(prog.rebuilds))
    settle("fused windows 3-4 (demoted, then k = 8)")
    require(dict(prog.rebuilds) == {"new_window": 1,
                                    CAUSE_REPLICA_CHANGE: 2},
            f"hot-grain window rebuilds {dict(prog.rebuilds)}")
    dev_ms, host_ms = held_device_ms(window, reps=3)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    eng.wait_completion()
    ev[0].record()
    t0 = time.perf_counter()
    for _ in range(4):
        window()
    ev[1].record()
    ev[1].synchronize()
    elapsed = time.perf_counter() - t0
    stream_ms = ev[0].elapsed_time(ev[1])
    settle("timed windows at k = 8")
    out["counts"]["hot_grain_fused"] = _build.launch_counts()
    out["report"]["hot_grain_fused"] = _build.launch_report()
    require_launched(out["counts"]["hot_grain_fused"], "hot-grain fused",
                     ROUTING_HOT_KERNELS)
    require(out["report"]["hot_grain_fused"]["spread_replicas"]["replayed"]
            > 0, "spread_replicas never replayed")
    out["fused"] = dict(
        window_device_ms=dev_ms, window_host_ms=host_ms,
        messages_per_sec=2 * HOT_SOURCES * 64 / elapsed,
        idle_share=1 - 4 * dev_ms / stream_ms, rebuilds=dict(prog.rebuilds),
        rebuilds_by_window=rebuilds, per_replay=dict(prog._per_replay),
        ticks=fused["ticks"])
    demote()
    check("the last demote")
    require(not sink_arena._replicas, "a group outlived the last demote")

    # K4's share of each arm's tick: the tick's two seg_sum launches timed
    # alone on the arm's spread rows (L2 flushed) over the tick's device
    # time — an estimate from kernel timings, not a trace
    timer = Timer(dev)
    ones_d = torch.ones(HOT_SOURCES, dtype=torch.int32, device=dev)
    n_rows = sink_arena.capacity
    for name, rows in arm_rows.items():
        rows_d = torch.from_numpy(rows.astype(np.int32)).to(dev)
        # integer values below 2**24 in all: exact in any order
        for vals in (values_d, ones_d):
            require(torch.equal(segment.seg_sum(vals, rows_d, n_rows),
                                segment.seg_sum_plain(vals, rows_d, n_rows)),
                    f"seg_sum != plain on arm {name}'s rows")
        k4 = timer(lambda: segment.seg_sum(values_d, rows_d, n_rows)) \
            + timer(lambda: segment.seg_sum(ones_d, rows_d, n_rows))
        a = out["arms"][name]
        plan = segment.seg_plan(len(rows), n_rows, 1, torch.float32)
        a.update(k4_ms=k4, k4_share=k4 / a["tick_device_ms"],
                 k4_path="direct" if plan.cluster == 0
                 else f"privatized, clusters of {plan.cluster}")
    for name, a in out["arms"].items():
        print(f"hot-grain arm {name} (k = {a['k']}): "
              f"{a['tick_device_ms']:.4f} ms per tick on the device, "
              f"{a['tick_host_ms']:.4f} on the host; K4 {a['k4_ms']:.4f} ms "
              f"({a['k4_path']}) "
              f"= {a['k4_share']:.3f} of the tick; {a['messages_per_sec']:.1f}"
              f" messages/s pipelined over {HOT_TICKS} ticks; "
              f"{a['spread_launches']} K18 launches in {a['ticks']} ticks; "
              f"exact; on {card}", flush=True)
    f = out["fused"]
    print(f"hot-grain fused, k = 8: one window of 16 "
          f"{f['window_device_ms']:.4f} ms on the device, "
          f"{f['window_host_ms']:.4f} ms on the host, "
          f"{f['messages_per_sec']:.1f} messages/s over 4 pipelined windows, "
          f"idle share {f['idle_share']:.4f}; rebuilds "
          f"{json.dumps(f['rebuilds'])}; one replay = "
          f"{json.dumps(f['per_replay'])}; {HOT_SOURCES} sources / "
          f"{HOT_SINKS} sinks, exact after every arm, promote and demote; "
          f"on {card}", flush=True)
    return out


def gps_oracle(lon: np.ndarray, fixes: list) -> dict:
    """The GPS columns after ``fixes`` ([(lat float32 [n], ts)] in tick
    order, ``lon`` fixed): per device moves, the last fix and speed (0 for
    the first fix and an unmoved one; else |dlat| in radians times R over
    dt, in float64 from the float32 fixes, lon never moving); per
    notifier the forwarded count, the ticks with traffic and the speed
    sum."""
    from orleans_tpu_torch.samples.gpstracker import EARTH_R, N_NOTIFIERS

    n = len(lon)
    notif = np.arange(n) % N_NOTIFIERS
    moves = np.zeros(n, np.int64)
    fwd = np.zeros(N_NOTIFIERS, np.int64)
    batches = np.zeros(N_NOTIFIERS, np.int64)
    ssum = np.zeros(N_NOTIFIERS, np.float64)
    prev_lat = prev_ts = speed = None
    for lat, ts in fixes:
        if prev_lat is None:
            moved = np.ones(n, bool)
            speed = np.zeros(n)
        else:
            moved = lat != prev_lat
            dlat = np.abs(lat.astype(np.float64) - prev_lat)
            speed = np.where(moved, np.deg2rad(dlat) * EARTH_R
                             / float(ts - prev_ts), 0.0)
        moves += moved
        cnt = np.bincount(notif, weights=moved, minlength=N_NOTIFIERS)
        fwd += cnt.astype(np.int64)
        batches += cnt > 0
        ssum += np.bincount(notif, weights=speed, minlength=N_NOTIFIERS)
        prev_lat, prev_ts = lat, ts
    return dict(moves=moves, lat=prev_lat, ts=prev_ts, speed=speed,
                forwarded=fwd, batches=batches, speed_sum=ssum)


def check_gps(engine, want: dict, what: str) -> float:
    """The engine's GPS columns against ``gps_oracle``: moves, lat, ts and
    the notifier counts exact, speed within a relative 1e-5 (cos and sqrt
    by an ulp, the constants' float32 roundings), speed_sum within 1e-5 of
    itself plus Higham's bound.  Returns the largest relative speed
    error."""
    from orleans_tpu_torch.samples.gpstracker import N_NOTIFIERS

    n = len(want["moves"])
    da = engine.arena_for("DeviceGrain")
    rows, found = da.lookup_rows(np.arange(n, dtype=np.int64))
    require(bool(found.all()), f"{what}: devices live")
    cols = {c: da.state[c].cpu().numpy()[rows] for c in da.state}
    require(np.array_equal(cols["moves"], want["moves"]), f"{what}: moves")
    require(np.array_equal(cols["lat"], want["lat"]), f"{what}: lat")
    require(bool(np.all(cols["ts"] == want["ts"])), f"{what}: ts")
    err = np.abs(cols["speed"] - want["speed"])
    require(bool(np.all(err <= 1e-5 * np.abs(want["speed"]))),
            f"{what}: speed beyond a relative 1e-5")
    na = engine.arena_for("PushNotifierGrain")
    nrows, nfound = na.lookup_rows(np.arange(N_NOTIFIERS, dtype=np.int64))
    require(bool(nfound.all()), f"{what}: notifiers live")
    ncols = {c: na.state[c].cpu().numpy()[nrows] for c in na.state}
    require(np.array_equal(ncols["forwarded"], want["forwarded"]),
            f"{what}: forwarded")
    require(np.array_equal(ncols["batches"], want["batches"]),
            f"{what}: batches")
    serr = np.abs(ncols["speed_sum"] - want["speed_sum"])
    stol = (1e-5 + 2 * want["forwarded"] * 2.0**-24) * want["speed_sum"]
    require(bool(np.all(serr <= stol)), f"{what}: speed_sum")
    moved = want["speed"] > 0
    return float((err[moved] / want["speed"][moved]).max())


def drive_gps_path(dev, card: str) -> dict:
    """GPSTracker at bench.py's default of 200,000 devices: unfused
    (``run_gps_load``, 20 ticks, auto-fusion off) and fused
    (``run_gps_load_fused``, a warm window and 20 ticks in windows of
    10), each against the numpy oracle of its seeded fixes."""
    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.samples import gpstracker as gps
    from orleans_tpu_torch.tensor.engine import TensorEngine

    out = {"counts": {}, "report": {}}
    n = GPS_DEVICES
    gc.collect()
    _build.reset_launch_counts()
    eng = TensorEngine(device=dev, config=TensorEngineConfig(
        auto_fusion_ticks=0))
    # the notifiers active first, as the fused loader has them: a cold
    # notifier's first deliveries would land at a later drain, and the
    # oracle's per-tick ``batches`` assumes every tick delivers in itself
    eng.arena_for("PushNotifierGrain").resolve_rows(
        np.arange(gps.N_NOTIFIERS, dtype=np.int64))
    st = asyncio.run(gps.run_gps_load(eng, n_devices=n, n_ticks=GPS_TICKS,
                                      seed=0))
    out["counts"]["gps_unfused"] = _build.launch_counts()
    require_launched(out["counts"]["gps_unfused"], "gps unfused",
                     GPS_KERNELS)
    rng = np.random.default_rng(0)
    lat = 47.6 + rng.random(n, dtype=np.float32) * 0.1
    lon = -122.1 + rng.random(n, dtype=np.float32) * 0.1
    fixes = []
    for t in range(GPS_TICKS):
        moving = rng.random(n) < 0.7
        lat = lat + np.where(moving, 1e-4, 0.0).astype(np.float32)
        fixes.append((lat, np.float32(t + 1)))
    want = gps_oracle(lon, fixes)
    st["speed_rel_err"] = check_gps(eng, want, "gps unfused")
    require(st["notified"] == int(want["forwarded"].sum()),
            "gps unfused: notified")
    out["unfused"] = st
    del eng
    gc.collect()

    _build.reset_launch_counts()
    eng = TensorEngine(device=dev)
    fs = asyncio.run(gps.run_gps_load_fused(
        eng, n_devices=n, n_ticks=GPS_TICKS, window=GPS_WINDOW, seed=0))
    out["counts"]["gps_fused"] = _build.launch_counts()
    out["report"]["gps_fused"] = _build.launch_report()
    require_launched(out["counts"]["gps_fused"], "gps fused", GPS_KERNELS)
    require(out["report"]["gps_fused"]["gather_rows"]["replayed"] > 0,
            "gather_rows never replayed")
    lon, windows = gps.gps_windows(n, GPS_TICKS // GPS_WINDOW + 1,
                                   GPS_WINDOW, 0.7, 0)
    fixes = [(w["lat"][t], w["ts"][t][0]) for w in windows
             for t in range(GPS_WINDOW)]
    want = gps_oracle(lon, fixes)
    fs["speed_rel_err"] = check_gps(eng, want, "gps fused")
    require(fs["forwarded_total"] == int(want["forwarded"].sum()),
            "gps fused: forwarded")
    out["fused"] = fs
    print(f"gps {n} devices: unfused {st['messages_per_sec']:.1f} "
          f"messages/s over {GPS_TICKS} ticks ({st['seconds']:.4f} s), "
          f"fused {fs['messages_per_sec']:.1f} messages/s over "
          f"{GPS_TICKS} ticks in windows of {GPS_WINDOW} "
          f"({fs['seconds']:.4f} s); moves, fixes and notifier counts "
          f"exact, speed within "
          f"{max(st['speed_rel_err'], fs['speed_rel_err']):.2e} relative; "
          f"on {card}", flush=True)
    return out


def twitter_oracle(payloads: list, tag_keys: np.ndarray) -> dict:
    """Per tag (``tag_keys`` order): total, positive, negative, counted,
    the scores of its last tick (a [tags, 3] flag set over -1, 0, +1) and
    its last lane's score; the counter (tags ever touched)."""
    order = np.argsort(tag_keys)
    n = len(tag_keys)
    total = np.zeros(n, np.int64)
    pos = np.zeros(n, np.int64)
    neg = np.zeros(n, np.int64)
    flags = np.zeros((n, 3), bool)
    last = np.zeros(n, np.int64)
    for keys, scores in payloads:
        idx = order[np.searchsorted(tag_keys[order], keys)]
        hits = np.bincount(idx, minlength=n)
        total += hits
        pos += np.bincount(idx[scores > 0], minlength=n)
        neg += np.bincount(idx[scores < 0], minlength=n)
        tick = np.zeros((n, 3), bool)
        tick[idx, scores + 1] = True
        flags[hits > 0] = tick[hits > 0]
        last[idx] = scores  # numpy fancy assignment: the last lane wins
    counted = (total > 0).astype(np.int64)
    return dict(total=total, positive=pos, negative=neg, counted=counted,
                flags=flags, last=last, counter=int(counted.sum()))


def check_twitter(engine, tag_keys, want: dict, what: str,
                  last_exact: bool = False) -> None:
    """Sums, counted and the counter exact; ``last_score`` one of the
    scores of the tag's last tick (0 for an untouched tag), or its last
    lane exactly when ``last_exact``."""
    from orleans_tpu_torch.samples.twitter_sentiment import COUNTER_KEY

    arena = engine.arena_for("HashtagGrain")
    rows, found = arena.lookup_rows(tag_keys)
    live = want["total"] > 0
    require(bool(found[live].all()), f"{what}: touched tags live")
    cols = {c: np.where(found, arena.state[c].cpu().numpy()[
        np.where(found, rows, 0)], 0) for c in arena.state}
    for c in ("total", "positive", "negative", "counted"):
        require(np.array_equal(cols[c], want[c]), f"{what}: {c}")
    last = cols["last_score"]
    if last_exact:
        require(np.array_equal(last, want["last"]), f"{what}: last_score")
    else:
        in_set = want["flags"][np.arange(len(last)),
                               np.clip(last + 1, 0, 2)] & (np.abs(last) <= 1)
        require(bool(np.where(live, in_set, last == 0).all()),
                f"{what}: last_score outside its last tick's scores")
    counter = engine.arena_for("TweetCounterGrain").read_row(COUNTER_KEY)
    require(int(counter["hashtags"]) == want["counter"], f"{what}: counter")


def drive_twitter_path(dev, card: str) -> dict:
    """TwitterSentiment at bench.py's defaults (100,000 tweets per tick,
    20,000 hashtags, 2 tags a tweet): unfused (20 ticks, auto-fusion off)
    and fused (windows of 10, the warm window rolled back), both against
    the numpy oracle of the Zipf payloads; then the grouped pull-mode
    path at ``_streams_twitter``'s 50,000 / 10,000, 10 ticks in one
    window, against the ungrouped unfused run and a numpy replay of each
    tag's last lane."""
    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.samples import twitter_sentiment as tw
    from orleans_tpu_torch.tensor.engine import TensorEngine

    def unfused_engine():
        return TensorEngine(device=dev, config=TensorEngineConfig(
            auto_fusion_ticks=0))

    out = {"counts": {}, "report": {}}
    tag_keys, payloads = tw._zipf_payloads(TW_TAGS, 2 * TW_TWEETS, TW_TICKS,
                                           1.4, 0)
    want = twitter_oracle(payloads, tag_keys)
    gc.collect()
    _build.reset_launch_counts()
    eng = unfused_engine()
    st = asyncio.run(tw.run_twitter_load(eng, n_tweets_per_tick=TW_TWEETS,
                                         n_hashtags=TW_TAGS,
                                         n_ticks=TW_TICKS))
    out["counts"]["twitter_unfused"] = _build.launch_counts()
    require_launched(out["counts"]["twitter_unfused"], "twitter unfused",
                     TWITTER_UNFUSED_KERNELS)
    check_twitter(eng, tag_keys, want, "twitter unfused")
    out["unfused"] = st
    del eng
    gc.collect()

    _build.reset_launch_counts()
    eng = TensorEngine(device=dev)
    fs = asyncio.run(tw.run_twitter_load_fused(
        eng, n_tweets_per_tick=TW_TWEETS, n_hashtags=TW_TAGS,
        n_ticks=TW_TICKS, window=TW_WINDOW))
    out["counts"]["twitter_fused"] = _build.launch_counts()
    out["report"]["twitter_fused"] = _build.launch_report()
    require_launched(out["counts"]["twitter_fused"], "twitter fused",
                     TWITTER_KERNELS)
    require(out["report"]["twitter_fused"]["resolve_sorted"]["replayed"]
            > 0, "resolve_sorted never replayed")
    check_twitter(eng, tag_keys, want, "twitter fused")
    out["fused"] = fs
    del eng
    gc.collect()

    gkeys, gpay = tw._zipf_payloads(TWG_TAGS, 2 * TWG_TWEETS, TWG_TICKS,
                                    1.4, 0)
    gwant = twitter_oracle(gpay, gkeys)
    _build.reset_launch_counts()
    eng = TensorEngine(device=dev)
    gs = asyncio.run(tw.run_twitter_load_grouped(
        eng, n_tweets_per_tick=TWG_TWEETS, n_hashtags=TWG_TAGS,
        n_ticks=TWG_TICKS, window=TWG_TICKS))
    out["counts"]["twitter_grouped"] = _build.launch_counts()
    out["report"]["twitter_grouped"] = _build.launch_report()
    require_launched(out["counts"]["twitter_grouped"], "twitter grouped",
                     TWITTER_GROUPED_KERNELS)
    require(out["report"]["twitter_grouped"]["seg_pull"]["replayed"] > 0,
            "seg_pull never replayed on the grouped path")
    check_twitter(eng, gkeys, gwant, "twitter grouped", last_exact=True)
    ung = unfused_engine()
    asyncio.run(tw.run_twitter_load(ung, n_tweets_per_tick=TWG_TWEETS,
                                    n_hashtags=TWG_TAGS, n_ticks=TWG_TICKS))
    check_twitter(ung, gkeys, gwant, "twitter ungrouped")
    a1, a2 = eng.arena_for("HashtagGrain"), ung.arena_for("HashtagGrain")
    r1 = a1.lookup_rows(gkeys)[0]
    r2, ok2 = a2.lookup_rows(gkeys)
    for c in ("total", "positive", "negative", "counted"):
        x1 = a1.state[c].cpu().numpy()[r1]
        x2 = a2.state[c].cpu().numpy()[np.where(ok2, r2, 0)]
        require(np.array_equal(x1[ok2], x2[ok2])
                and not np.any(x1[~ok2]), f"grouped != ungrouped ({c})")
    out["grouped"] = gs
    print(f"twitter {TW_TWEETS} tweets / {TW_TAGS} tags per tick: unfused "
          f"{st['messages_per_sec']:.1f} messages/s over {TW_TICKS} ticks "
          f"({st['seconds']:.4f} s), fused {fs['messages_per_sec']:.1f} "
          f"messages/s in windows of {TW_WINDOW} ({fs['seconds']:.4f} s); "
          f"sums, counted and the counter exact against the numpy oracle, "
          f"last_score within its last tick's scores; grouped "
          f"{TWG_TWEETS} / {TWG_TAGS}, {TWG_TICKS} ticks: "
          f"{gs['messages_per_sec']:.1f} messages/s ({gs['seconds']:.4f} "
          f"s), equal to the ungrouped run, last_score exact; on {card}",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 11: the durable state plane
# ---------------------------------------------------------------------------

def check_checkpoint_kernels(dev, timer, card: str) -> dict:
    """K19–K21 against their plain versions on the card, bit for bit, each
    timed beside its bound, its plain version and a library yardstick.
    K19 on 4,194,304 rows of the Presence arena's columns (three int32
    state columns and the int32 clock) plus a bool and an ``[n, 3]`` int32
    column; K20 on drain chunks of 65,536 rows of those four columns and
    on one short chunk padded to a power of two, its copy off the card
    timed apart; K21 on 4,194,304 rows in both modes, clocks equal to the
    cutoff among them."""
    from orleans_tpu_torch.device import pow2_pad
    from orleans_tpu_torch.kernels import checkpoint as kck

    rng = np.random.default_rng(1919)
    n = CKPT_ROWS

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    presence = [t(rng.integers(0, 2**31 - 1, n).astype(np.int32))
                for _ in range(4)]
    extra = [t(rng.random(n) < 0.5),
             t(rng.integers(-2**31, 2**31 - 1, (n, 3)).astype(np.int32))]
    cols = presence + extra
    out = [torch.empty_like(c) for c in cols]
    got = kck.pin_columns(cols, out)
    require(all(torch.equal(c, g) for c, g in zip(cols, got)),
            "pin_columns != its source")
    require(all(torch.equal(a, b) for a, b in zip(
        kck.pin_columns(cols), kck.pin_columns_plain(cols))),
        "pin_columns != plain")
    nbytes = sum(c.numel() * c.element_size() for c in cols)
    r = dict(bound=bound(2 * nbytes), **measure(
        timer, lambda: kck.pin_columns(cols, out),
        lambda: kck.pin_columns_plain(cols, out),
        lambda: torch._foreach_copy_(out, cols)))
    r.update(max_abs_err=0,
             library="torch._foreach_copy_ over the columns (the plain "
                     "version is the per-column copy_ loop)")
    results = {"pin_columns": r}
    print(f"kernel pin_columns: {r['ms']:.4f} ms on the device (copy_ loop "
          f"{r['plain_ms']:.4f}, _foreach_copy_ {r['library_ms']:.4f}, "
          f"bound {r['bound'][0]:.4f} by {r['bound'][1]}); {n} rows, "
          f"{nbytes} bytes in 6 columns; on {card}", flush=True)

    # K20: the drain's chunks of a full live arena (ascending rows)
    m = CKPT_CHUNK
    idx = t(np.arange(m, dtype=np.int32) + 7 * m)
    staging, views = kck.gather_columns(presence, idx)
    want_s, want_v = kck.gather_columns_plain(presence, idx)
    require(torch.equal(staging, want_s), "gather_columns != plain")
    short = rng.integers(0, n, 1000).astype(np.int32)
    short_d = t(pow2_pad(short, 0))
    s_short, v_short = kck.gather_columns(cols, short_d)
    w_short, wv_short = kck.gather_columns_plain(cols, short_d)
    require(all(torch.equal(a, b) for a, b in zip(v_short, wv_short)),
            "gather_columns != plain (short chunk)")
    host = torch.empty(staging.shape, dtype=torch.uint8, pin_memory=True)
    clamped = idx.clamp(0, n - 1).long()

    def loop():
        return [c.index_select(0, clamped) for c in presence]

    copy_ms = timer(lambda: host.copy_(staging, non_blocking=True))
    r = dict(bound=bound(m * 16 * 2 + 4 * m), **measure(
        timer, lambda: kck.gather_columns(presence, idx),
        lambda: kck.gather_columns_plain(presence, idx), None))
    r["loop_ms"] = timer(loop)
    r["copy_ms"] = copy_ms
    r.update(max_abs_err=0, library=None,
             library_note=f"no single PyTorch call: the per-column "
                          f"index_select loop takes {r['loop_ms']:.4f} ms; "
                          f"the chunk's one copy off the card into pinned "
                          f"memory {copy_ms:.4f} ms")
    results["gather_columns"] = r
    print(f"kernel gather_columns: {r['ms']:.4f} ms on the device (plain "
          f"{r['plain_ms']:.4f}, index_select loop {r['loop_ms']:.4f}, "
          f"bound {r['bound'][0]:.4f} by {r['bound'][1]}); the chunk's copy "
          f"off the card {copy_ms:.4f} ms; {m} rows x 16 B; a 1000-row "
          f"chunk padded to 1024 exact; on {card}", flush=True)
    del staging, views, want_s, want_v, host

    # K21: the delta's dirty mask over the arena
    counts = rng.integers(0, 5, n).astype(np.int32)
    pinned = np.where(rng.random(n) < 0.05, counts + 1, counts).astype(
        np.int32)
    args = [t(counts), t(pinned), t(rng.integers(0, 64, n).astype(np.int32)),
            t(rng.integers(0, 64, n).astype(np.int32)), t(rng.random(n) < 0.9)]
    require(int((torch.maximum(args[2], args[3]) == 32).sum()) > 0,
            "no clock equals the cutoff")
    for mode in ("dirty", "touched"):
        a = list(args) if mode == "dirty" else [None, None] + list(args[2:])
        for cutoff in (32, 0, -2**31 + 1, 2**31 - 1):
            require(torch.equal(kck.dirty_mask(*a, cutoff),
                                kck.dirty_mask_plain(*a, cutoff)),
                    f"dirty_mask != plain ({mode}, {cutoff})")
    c, p, cd, ch, lv = args

    def composite():
        return lv & ((c != p) | torch.ge(torch.maximum(cd, ch), 32))

    r = dict(bound=bound(18 * n), **measure(
        timer, lambda: kck.dirty_mask(c, p, cd, ch, lv, 32),
        lambda: kck.dirty_mask_plain(c, p, cd, ch, lv, 32), None))
    r["composite_ms"] = timer(composite)
    r["touched_ms"] = timer(lambda: kck.dirty_mask(None, None, cd, ch, lv,
                                                   32))
    r["touched_bound_ms"] = bound(10 * n)[0]
    r.update(max_abs_err=0, library=None,
             library_note=f"no single PyTorch call: maximum, ge, ne and & "
                          f"take {r['composite_ms']:.4f} ms; touched mode "
                          f"{r['touched_ms']:.4f} ms (bound "
                          f"{r['touched_bound_ms']:.4f})")
    results["dirty_mask"] = r
    print(f"kernel dirty_mask: {r['ms']:.4f} ms on the device in dirty mode "
          f"(plain {r['plain_ms']:.4f}, composite {r['composite_ms']:.4f}, "
          f"bound {r['bound'][0]:.4f} by {r['bound'][1]}), touched mode "
          f"{r['touched_ms']:.4f} (bound {r['touched_bound_ms']:.4f}); {n} "
          f"rows; on {card}", flush=True)
    return results


def _durable_engine(dev, store=None, **cfg):
    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.samples import banking, presence  # noqa: F401
    from orleans_tpu_torch.tensor.engine import TensorEngine

    return TensorEngine(device=dev, snapshot_store=store,
                        config=TensorEngineConfig(**cfg))


def _host_state(engine, type_names) -> dict:
    """Every state column, the clocks and the identity of each arena, on
    the host."""
    from orleans_tpu_torch.device import fetch_host

    out = {}
    for t in type_names:
        a = engine.arena_for(t)
        out[t] = dict(cols=fetch_host(
            {**a.state, "__last_use_dev": a.last_use_dev}),
            key_of_row=a._key_of_row.copy(), generation=a.generation,
            eviction_epoch=a.eviction_epoch, clock=a.host_clock())
    return out


def _same_state(want: dict, engine, what: str) -> None:
    got = _host_state(engine, list(want))
    for t, w in want.items():
        g = got[t]
        require(np.array_equal(g["key_of_row"], w["key_of_row"])
                and g["generation"] == w["generation"]
                and g["eviction_epoch"] == w["eviction_epoch"],
                f"{what}: {t} identity differs after recovery")
        live = w["key_of_row"] >= 0
        require(np.array_equal(g["clock"][live], w["clock"][live]),
                f"{what}: {t} host clock differs")
        for name, col in w["cols"].items():
            require(np.array_equal(g["cols"][name], col),
                    f"{what}: {t}.{name} differs after recovery")


def _kill() -> None:
    """The end of a hard kill, once the caller dropped its engines without
    a flush: collect them and free the card's memory."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def durability_restore(dev, n_players: int, store_factory, what: str,
                       reps: int) -> dict:
    """bench.py ``_durability_restore_scale``: Presence through
    ``run_presence_load_fused`` (6 ticks, window 3), a full checkpoint
    drained synchronously (best of ``reps``), a hard kill, ``recover()``
    on fresh engines (best of ``reps``); identity and every state column
    equal the pre-kill engine."""
    from orleans_tpu_torch.samples.presence import run_presence_load_fused

    types = ("PresenceGrain", "GameGrain")
    engine = _durable_engine(dev, store_factory())
    asyncio.run(run_presence_load_fused(engine, n_players=n_players,
                                        n_games=n_players // 100,
                                        n_ticks=6, window=3))
    snap_s, cp = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        cp = engine.checkpointer.checkpoint_full()
        snap_s = min(snap_s, time.perf_counter() - t0)
    want = _host_state(engine, types)
    del engine
    _kill()
    restore_s, stats, engine2 = float("inf"), None, None
    for _ in range(reps):
        engine2 = None
        _kill()
        engine2 = _durable_engine(dev, store_factory())
        t0 = time.perf_counter()
        stats = asyncio.run(engine2.checkpointer.recover())
        torch.cuda.synchronize()
        restore_s = min(restore_s, time.perf_counter() - t0)
    require(stats["recovered"] and stats["restored_rows"] == cp["rows"],
            f"{what}: recovered {stats}")
    _same_state(want, engine2, what)
    out = dict(players=n_players, rows=cp["rows"], bytes=cp["bytes"],
               snapshot_seconds=snap_s, restore_seconds=restore_s,
               snapshot_rows_per_sec=cp["rows"] / snap_s,
               restore_rows_per_sec=stats["restored_rows"] / restore_s,
               exact=True)
    del engine2
    _kill()
    return out


def _device_us(evt) -> float:
    """Device time of a traced kernel or copy (0 for a host op, whose
    device total would count its kernels again)."""
    from torch.autograd import DeviceType

    if evt.device_type != DeviceType.CUDA:
        return 0.0
    for attrs in (("self_device_time_total", "device_time_total"),
                  ("self_cuda_time_total", "cuda_time_total")):
        if hasattr(evt, attrs[0]):
            return max(float(getattr(evt, a)) for a in attrs)
    return 0.0


def _split_us(fn, calls: int = 10, tries: int = 3) -> dict:
    """Device µs a call of each kernel ``fn`` launches, by kernel name, as
    ``torch.profiler`` reads them over ``calls`` calls after a warm one;
    a trace with no device time (the profiler drops one now and then) is
    taken again, up to ``tries`` times, and {} means not measured."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            us = _device_us(evt)
            if us > 0:
                name = evt.key.replace("(anonymous namespace)::", "") \
                    .split("(")[0].split("<")[0].split("::")[-1].split()[-1]
                out[name] = out.get(name, 0.0) + us / calls
        if out:
            break
    return out


def _traced_device_ms(fn) -> float:
    """Device time of everything ``fn`` enqueues (kernels and copies), by
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(_device_us(e) for e in prof.key_averages()) / 1e3


def durability_cadence(dev, fuse: bool) -> dict:
    """The live cadence on Presence 1M/10k: fulls every 32 ticks, deltas
    every 8, a 5 ms pause budget, the heartbeat site journaled and sealed
    every 4 ticks, 64 ticks through an injector (auto-fused at the default
    window when ``fuse``), traced against the same ticks on an engine
    without the plane; then a hard kill and ``recover()``, exact at the
    acknowledged horizon (``total_score`` within the fan-in bound)."""
    from orleans_tpu_torch.kernels import checkpoint as kck
    from orleans_tpu_torch.tensor import checkpoint as ckpt_mod
    from orleans_tpu_torch.tensor.checkpoint import MemorySnapshotStore

    modes = {"dirty": 0, "touched": 0}
    dirty_rows = []

    def counted_mask(counts, *args):
        modes["dirty" if counts is not None else "touched"] += 1
        mask = kck.dirty_mask(counts, *args)
        dirty_rows.append(int(mask.sum()))  # per arena, before key churn
        return mask

    backing = {}
    # the journal holds the 4 ticks between seals (bench.py's sizing), so
    # no 1M-lane batch seals by ring overflow
    cfg = dict(auto_fusion_ticks=16 if fuse else 0,
               ckpt_full_every_ticks=32, ckpt_delta_every_ticks=8,
               ckpt_pause_budget_s=0.005, journal_flush_every_ticks=4,
               journal_ring_lanes=PLAYERS * 5)
    rng = np.random.default_rng(11)
    keys = np.arange(PLAYERS, dtype=np.int64)
    games = rng.integers(0, GAMES, PLAYERS).astype(np.int32)
    scores = rng.random(PLAYERS, dtype=np.float32)
    games_d, scores_d = (torch.from_numpy(a).to(dev) for a in (games, scores))
    ms = {}
    # count K21's launches by mode (the plane calls it by this name)
    ckpt_mod.dirty_mask = counted_mask
    try:
        for plane in (False, True):
            eng = _durable_engine(
                dev, MemorySnapshotStore(backing) if plane else None, **cfg)
            eng.arena_for("PresenceGrain").reserve(PLAYERS)
            eng.arena_for("GameGrain").reserve(GAMES)
            if plane:
                eng.register_journal("PresenceGrain", "heartbeat")
            inj = eng.make_injector("PresenceGrain", "heartbeat", keys)

            def ticks():
                for t in range(CADENCE_TICKS):
                    inj.inject({"game": games_d, "score": scores_d,
                                "tick": np.int32(t + 1)})
                    eng.run_tick()

            t0 = time.perf_counter()
            ms[plane] = _traced_device_ms(ticks) / CADENCE_TICKS
            wall = time.perf_counter() - t0
            if not plane:
                del eng, inj
                _kill()
        asyncio.run(eng.flush())
    finally:
        ckpt_mod.dirty_mask = kck.dirty_mask
    ck = eng.checkpointer
    acked = ck.journal.sites[("PresenceGrain", "heartbeat")] \
        .committed_lanes // PLAYERS
    require(0 < acked <= CADENCE_TICKS, f"{acked} acknowledged ticks")
    pauses = np.asarray(ck.pauses)
    out = dict(fused=fuse, device_ms_per_tick=ms[True],
               device_ms_per_tick_without=ms[False],
               wall_seconds=wall, fulls=ck.full_snapshots,
               deltas=ck.delta_snapshots, dirty_rows_per_delta=dirty_rows,
               segments=ck.journal.segments_committed,
               ring_overflows=ck.journal.ring_overflows,
               pause_p50_ms=float(np.percentile(pauses, 50)) * 1e3
               if len(pauses) else 0.0,
               pause_p99_ms=float(np.percentile(pauses, 99)) * 1e3
               if len(pauses) else 0.0,
               acked_ticks=acked, dirty_mode_masks=modes["dirty"],
               touched_mode_masks=modes["touched"],
               windows=eng.autofuser.snapshot()["windows_run"])
    if not fuse:
        require(ck.full_snapshots >= 1 and ck.delta_snapshots >= 1,
                f"cadence: {ck.full_snapshots} fulls, {ck.delta_snapshots} "
                f"deltas")
        require(modes["dirty"] > 0, "dirty_mask never ran in dirty mode")
    else:
        # the plane runs on unfused ticks only (as in the JAX package):
        # the windows journal their ingress but seal and cut nothing
        require(out["windows"] > 0, "the fused cadence arm never fused")
    del eng, inj, ck
    _kill()
    eng2 = _durable_engine(dev, MemorySnapshotStore(backing), **cfg)
    st = asyncio.run(eng2.checkpointer.recover())
    require(st["recovered"], f"cadence recover {st}")
    pa = eng2.arena_for("PresenceGrain")
    rows, found = pa.lookup_rows(keys)
    require(found.all(), "a player was not recovered")
    cols = {k: v.cpu().numpy()[rows] for k, v in pa.state.items()}
    require(np.array_equal(cols["heartbeats"], np.full(PLAYERS, acked))
            and np.array_equal(cols["game"], games),
            f"cadence ({'fused' if fuse else 'unfused'}): players differ "
            f"at the acknowledged horizon ({acked} ticks)")
    # an auto-fused window's buffered ticks share one inject tick (as in
    # the JAX package), so replay runs them as one tick and a SET column
    # keeps any one of their writers: exact unfused, within the window
    # fused
    last = cols["last_heartbeat"]
    out["last_heartbeat_exact"] = bool(np.all(last == acked))
    lo = acked - (16 if fuse else 0)
    require(bool(np.all((last >= lo) & (last <= acked))),
            f"cadence: last_heartbeat outside [{lo}, {acked}]")
    ga = eng2.arena_for("GameGrain")
    grows, gfound = ga.lookup_rows(np.arange(GAMES, dtype=np.int64))
    require(gfound.all(), "a game was not recovered")
    want_upd = np.bincount(games, minlength=GAMES) * acked
    require(np.array_equal(ga.state["updates"].cpu().numpy()[grows],
                           want_upd), "cadence: game updates differ")
    want_tot = np.bincount(games, weights=scores.astype(np.float64),
                           minlength=GAMES) * acked
    tol = _fan_in_tol(np.tile(scores, acked), np.tile(games, acked), GAMES)
    got_tot = ga.state["total_score"].cpu().numpy()[grows].astype(np.float64)
    require(bool(np.all(np.abs(got_tot - want_tot) <= tol)),
            "cadence: total_score outside the fan-in bound")
    out["replayed_lanes"] = st["replayed_lanes"]
    out["recover_fused_windows"] = st["fused_windows"]
    del eng2, pa, ga
    _kill()
    return out


def durability_journal_fold(dev) -> dict:
    """bench.py ``_durability_journal_fold``: banking, 50,000 accounts,
    240 events of 32,768 lanes, the journal sized so no overflow seal
    fires, sealed every 8 ticks; a hard kill and recovery with fused
    windows of 64; every touched account equal to ``BankOracle`` and the
    balances conserve."""
    from orleans_tpu_torch.samples import banking
    from orleans_tpu_torch.tensor.checkpoint import MemorySnapshotStore

    backing = {}
    cfg = dict(auto_fusion_ticks=0,
               journal_ring_lanes=FOLD_LANES * (FOLD_EVENTS + 1),
               journal_flush_every_ticks=8, recover_fused_window=64)
    eng = _durable_engine(dev, MemorySnapshotStore(backing), **cfg)
    banking.register_banking_journal(eng)
    eng.checkpointer.checkpoint_full()
    events = banking.make_events(FOLD_ACCOUNTS, FOLD_EVENTS,
                                 lanes=FOLD_LANES, seed=17)
    run = asyncio.run(banking.run_banking_load(eng, events))
    j = eng.checkpointer.journal.snapshot()
    require(j["ring_overflows"] == 0, "the journal ring overflowed")
    acked = sum(s["committed_lanes"] for s in j["sites"].values()) \
        // FOLD_LANES
    require(0 < acked <= FOLD_EVENTS, f"{acked} acknowledged events")
    oracle = banking.BankOracle(FOLD_ACCOUNTS)
    for ev in events[:acked]:
        oracle.apply(ev)
    del eng
    _kill()
    eng2 = _durable_engine(dev, MemorySnapshotStore(backing), **cfg)
    banking.register_banking_journal(eng2)
    t0 = time.perf_counter()
    st = asyncio.run(eng2.checkpointer.recover())
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    touched = np.unique(np.concatenate(
        [np.concatenate([e["keys"], e.get("dst", np.empty(0, np.int64))])
         for e in events[:acked]])).astype(np.int64)
    got = banking.read_accounts(eng2, touched)
    want = oracle.expect(touched)
    require(all(np.array_equal(got[k], want[k]) for k in want),
            "journal fold: accounts differ from the oracle")
    a2 = eng2.arena_for("AccountGrain")
    live = a2._key_of_row >= 0
    require(int(a2.state["balance"].cpu().numpy()[live].astype(
        np.int64).sum()) == oracle.total(), "journal fold: conservation")
    out = dict(accounts=FOLD_ACCOUNTS, events=FOLD_EVENTS,
               acknowledged_events=acked,
               live_lanes_per_sec=run["lanes"] / run["seconds"],
               segments=j["segments_committed"],
               flush_seconds=j["flush_seconds"],
               replayed_lanes=st["replayed_lanes"],
               replay_lanes_per_sec=st["replayed_lanes"] / recover_s,
               recover_seconds=recover_s, fused_windows=st["fused_windows"],
               fused_lanes=st["fused_lanes"], exact=True)
    require(st["fused_windows"] > 0, "journal fold: no fused window")
    del eng2, a2
    _kill()
    return out


def durability_failover(dev) -> dict:
    """bench.py ``_durability_failover`` at 4,000,000 players: a standby
    tails the primary's full of the Presence arena and stages its sealed
    journal segments while journaled traffic runs (``AccountGrain.deposit``
    over 256 keys for 17 ticks, in place of the bench's chaos-ledger
    grain, which is not ported); the primary is killed and the standby
    promoted: RTO is ``promote()``'s wall time, the acknowledged prefix is
    exact and the old primary's next commit raises ``FencedError``."""
    from orleans_tpu_torch.samples.presence import run_presence_load_fused
    from orleans_tpu_torch.tensor.checkpoint import (
        FencedError,
        MemorySnapshotStore,
        StandbyTailer,
    )

    backing = {}
    cfg = dict(auto_fusion_ticks=0, journal_flush_every_ticks=3)
    primary = _durable_engine(dev, MemorySnapshotStore(backing), **cfg)
    primary.register_journal("AccountGrain", "deposit")
    asyncio.run(run_presence_load_fused(primary, n_players=RESTORE_PLAYERS,
                                        n_games=RESTORE_PLAYERS // 100,
                                        n_ticks=4, window=2))
    primary.checkpointer.checkpoint_full()
    standby = _durable_engine(dev, MemorySnapshotStore(backing), **cfg)
    standby.register_journal("AccountGrain", "deposit")
    tailer = StandbyTailer(standby, MemorySnapshotStore(backing))
    rng = np.random.default_rng(20260807)
    keys = np.arange(256, dtype=np.int64)
    amounts_by_tick = []
    for t in range(17):
        amounts = rng.integers(1, 100, 256).astype(np.int32)
        amounts_by_tick.append(amounts)
        primary.send_batch("AccountGrain", "deposit", keys,
                           {"amount": amounts})
        primary.run_tick()
        if t % 3 == 2:
            tailer.poll()
    asyncio.run(primary.flush())
    require(tailer.adopted_rows > 0, "the standby never adopted the full")
    acked = primary.checkpointer.journal.sites[
        ("AccountGrain", "deposit")].committed_lanes // 256
    require(0 < acked < 17, f"{acked} acknowledged ticks")
    oracle = np.sum(amounts_by_tick[:acked], axis=0)
    lag = tailer.lag_ticks()
    t0 = time.perf_counter()
    res = asyncio.run(tailer.promote(owner="smoke-standby"))
    torch.cuda.synchronize()
    rto = time.perf_counter() - t0
    arena = standby.arena_for("AccountGrain")
    rows, found = arena.lookup_rows(keys)
    require(found.all() and np.array_equal(
        arena.state["balance"].cpu().numpy()[rows].astype(np.int64),
        oracle), "failover: the acknowledged prefix differs")
    try:
        primary.checkpointer.checkpoint_full()
        fenced = False
    except FencedError:
        fenced = True
    require(fenced and primary.checkpointer.fenced,
            "the old primary committed after the promotion")
    out = dict(players=RESTORE_PLAYERS, rto_s=rto,
               promote_seconds=res["seconds"], acked_ticks=acked,
               adopted_rows=res["adopted_rows"],
               replayed_lanes=res["replayed_lanes"],
               lag_ticks_before_promote=lag, fenced=fenced)
    del primary, standby, tailer, arena
    _kill()
    return out


def drive_durability_path(dev, card: str, timer) -> dict:
    """Phase 11: K19–K21 against their plain versions; the restore probe
    at 4,000,000 players; the file store at 1,000,000; the live cadence
    unfused and fused at 1,000,000; the journal fold at 50,000 accounts
    and 240 x 32,768 lanes; the warm standby at 4,000,000.  Launch counts
    zeroed before each arm and read after it."""
    import tempfile
    from pathlib import Path

    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.tensor.checkpoint import (
        FileSnapshotStore,
        MemorySnapshotStore,
    )

    out = {"counts": {}, "report": {}}
    out["kernels"] = check_checkpoint_kernels(dev, timer, card)
    gc.collect()
    torch.cuda.empty_cache()
    arms = {}

    def arm(name, fn, kernels):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        arms[name] = fn()
        arms[name]["arm_seconds"] = time.perf_counter() - t0
        out["counts"][name] = _build.launch_counts()
        out["report"][name] = _build.launch_report()
        require_launched(out["counts"][name], name, kernels)
        require(out["counts"][name]["resolve_dense"]
                + out["counts"][name]["resolve_sorted"] > 0,
                f"no resolve kernel launched on the {name} path")

    backing = {}
    arm("durability_restore", lambda: durability_restore(
        dev, RESTORE_PLAYERS, lambda: MemorySnapshotStore(backing),
        "restore probe", 2), ("pin_columns", "gather_columns", "row_scatter"))
    backing.clear()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as root:
        arm("durability_file", lambda: durability_restore(
            dev, PLAYERS, lambda: FileSnapshotStore(root), "file store", 1),
            ("pin_columns", "gather_columns", "row_scatter"))
    arm("durability_cadence_unfused", lambda: durability_cadence(dev, False),
        ("pin_columns", "gather_columns", "dirty_mask", "row_scatter"))
    arm("durability_cadence_fused", lambda: durability_cadence(dev, True),
        ("pin_columns", "row_scatter", "seg_sum"))
    arm("durability_journal_fold", lambda: durability_journal_fold(dev),
        ("pin_columns", "row_scatter", "seg_sum"))
    arm("durability_failover", lambda: durability_failover(dev),
        ("pin_columns", "gather_columns", "row_scatter"))
    union = {}
    for c in out["counts"].values():
        for k, v in c.items():
            union[k] = union.get(k, 0) + v
    require_launched(union, "durability", DURABILITY_KERNELS)
    out["arms"] = arms
    r, f = arms["durability_restore"], arms["durability_file"]
    print(f"restore probe: {r['rows']} rows ({r['bytes']} bytes) "
          f"snapshot {r['snapshot_seconds']:.3f} s "
          f"({r['snapshot_rows_per_sec']:.0f} rows/s), restore "
          f"{r['restore_seconds']:.3f} s ({r['restore_rows_per_sec']:.0f} "
          f"rows/s), best of 2, exact; file store at {f['players']}: "
          f"snapshot {f['snapshot_seconds']:.3f} s, restore "
          f"{f['restore_seconds']:.3f} s, exact; on {card}", flush=True)
    for name in ("durability_cadence_unfused", "durability_cadence_fused"):
        c = arms[name]
        print(f"cadence {'fused' if c['fused'] else 'unfused'}: "
              f"{CADENCE_TICKS} ticks, {c['fulls']} fulls, {c['deltas']} "
              f"deltas ({c['dirty_rows_per_delta']} dirty rows), "
              f"{c['segments']} segments, pauses p50 "
              f"{c['pause_p50_ms']:.3f} ms p99 {c['pause_p99_ms']:.3f} ms, "
              f"device {c['device_ms_per_tick']:.4f} ms a tick with the "
              f"plane and {c['device_ms_per_tick_without']:.4f} without "
              f"(traced); K21 {c['dirty_mode_masks']} dirty-mode, "
              f"{c['touched_mode_masks']} touched-mode; killed and "
              f"recovered at {c['acked_ticks']} acknowledged ticks "
              f"(last_heartbeat exact: {c['last_heartbeat_exact']}) "
              f"({c['replayed_lanes']} lanes replayed, "
              f"{c['recover_fused_windows']} fused windows); on {card}",
              flush=True)
    j = arms["durability_journal_fold"]
    print(f"journal fold: {j['accounts']} accounts, {j['events']} events of "
          f"{FOLD_LANES} lanes, {j['acknowledged_events']} acknowledged; "
          f"append {j['live_lanes_per_sec']:.0f} lanes/s live, replay "
          f"{j['replay_lanes_per_sec']:.0f} lanes/s ({j['replayed_lanes']} "
          f"lanes in {j['recover_seconds']:.3f} s, {j['fused_windows']} "
          f"fused windows), exact, conserved; on {card}", flush=True)
    fo = arms["durability_failover"]
    print(f"warm standby at {fo['players']} players: RTO (promote) "
          f"{fo['rto_s']:.4f} s, {fo['adopted_rows']} rows adopted while "
          f"tailing, {fo['replayed_lanes']} lanes replayed, acknowledged "
          f"prefix ({fo['acked_ticks']} ticks) exact, old primary fenced; "
          f"on {card}", flush=True)
    print("durability arms: " + json.dumps(arms), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 12: clustered silos on one card — the cross-silo vector data plane
# ---------------------------------------------------------------------------

def _ring_split(keys: np.ndarray, n_silos: int):
    """The permutation of ``keys``'s lanes by ring owner over ``n_silos``
    silos (the first owner's lanes first, as a ClusterInjector lays out
    its local segment) and its segment bounds."""
    from orleans_tpu_torch.hashing import ring_hash_int_keys
    from orleans_tpu_torch.ids import SiloAddress
    from orleans_tpu_torch.ids import type_code_of
    from orleans_tpu_torch.runtime.ring import VirtualBucketsRing

    ring = VirtualBucketsRing(SiloAddress("silo1", 0, 1))
    for i in range(1, n_silos):
        ring.add_silo(SiloAddress(f"silo{i + 1}", 0, i + 1))
    owner, _ = ring.owners_of_hashes(ring_hash_int_keys(
        type_code_of("PresenceGrain"), keys))
    perm = np.argsort(owner, kind="stable").astype(np.int32)
    bounds = np.concatenate([[0], np.cumsum(np.bincount(
        owner, minlength=n_silos))]).tolist()
    return perm, bounds


def _same_pieces(got, want) -> bool:
    """Every (segment, leaf) piece equal bit for bit (the packed
    buffers' alignment padding is not compared: the kernel leaves it
    unwritten)."""
    return all(torch.equal(g, w) for gs, ws in zip(got, want)
               for g, w in zip(gs, ws))


def check_router_kernels(dev, timer, card: str) -> dict:
    """K22 ``gather_args`` against its plain version on the card, bit for
    bit: the Presence payload (game int32, score float32, tick int32 per
    lane) at 1,048,576 lanes split 2 and 3 ways by real ring ownership,
    each remote region fetched with one copy; ``m = 0``; an ``[n, 4]``
    float32 and an int64 leaf.  Timed at the 2-way split beside its bound,
    its plain version and the ``index_select`` loop."""
    from orleans_tpu_torch.kernels import router as kr

    rng = np.random.default_rng(2222)
    n = K22_LANES
    keys = np.arange(n, dtype=np.int64)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    leaves = [t(rng.integers(0, GAMES, n).astype(np.int32)),
              t(rng.random(n, dtype=np.float32)),
              t(np.full(n, 7, np.int32))]
    splits = {}
    for ways in (2, 3):
        perm, bounds = _ring_split(keys, ways)
        perm_d = t(perm)
        staging, views, layout = kr.gather_args(leaves, perm_d, bounds)
        _, want_views, _ = kr.gather_args_plain(leaves, perm_d, bounds)
        require(_same_pieces(views, want_views),
                f"gather_args != plain ({ways}-way split)")
        host = kr.fetch_segments(staging, layout, leaves, leaves)
        for seg, wv in zip(host, want_views[1:]):
            for h, w in zip(seg, wv):
                require(np.array_equal(h, w.cpu().numpy()),
                        f"gather_args remote region != plain ({ways}-way)")
        splits[ways] = (perm_d, bounds, [b - a for a, b in
                                         zip(bounds, bounds[1:])])
    wide = [t(rng.random((n, 4), dtype=np.float32)),
            t(rng.integers(-2**62, 2**62, n, dtype=np.int64))]
    perm_d, bounds, _ = splits[2]
    _, v_w, _ = kr.gather_args(wide, perm_d, bounds)
    require(_same_pieces(v_w, kr.gather_args_plain(wide, perm_d, bounds)[1]),
            "gather_args != plain ([n, 4] float32, int64)")
    before = kr.gather_args.launches
    _, v0, _ = kr.gather_args(leaves, perm_d[:0])
    require(kr.gather_args.launches == before
            and all(v.shape[0] == 0 for v in v0[0]),
            "gather_args with m = 0 launched or returned rows")
    perm_long = perm_d.long()
    row_bytes = sum(lf.element_size() for lf in leaves)
    r = dict(bound=bound(2 * n * row_bytes + 4 * n), **measure(
        timer, lambda: kr.gather_args(leaves, perm_d, bounds),
        lambda: kr.gather_args_plain(leaves, perm_d, bounds),
        lambda: [lf.index_select(0, perm_long) for lf in leaves]))
    perm3, bounds3, counts3 = splits[3]
    r["three_way_ms"] = timer(lambda: kr.gather_args(leaves, perm3, bounds3))
    r.update(max_abs_err=0,
             library="index_select per leaf over the whole split (one "
                     "call per leaf, no packing)",
             per={"lanes": n, "row_bytes": row_bytes,
                  "two_way_segments": splits[2][2],
                  "three_way_segments": counts3})
    print(f"kernel gather_args: {r['ms']:.4f} ms on the device at "
          f"{n} lanes x {row_bytes} B split 2 ways {splits[2][2]} (plain "
          f"{r['plain_ms']:.4f}, index_select loop {r['library_ms']:.4f}, "
          f"bound {r['bound'][0]:.4f} by {r['bound'][1]}), 3 ways "
          f"{r['three_way_ms']:.4f} ms; [n, 4] float32, int64 and m = 0 "
          f"exact; on {card}", flush=True)
    return {"gather_args": r}


def _bench_silo_config(name: str):
    """Bench-grade liveness and fence: host stalls of a 1M-key handoff
    must not make healthy silos suspect each other, nor time the handoff
    fence out before the pushed rows land."""
    from orleans_tpu_torch.config import SiloConfig

    c = SiloConfig(name=name)
    c.liveness.probe_timeout = 2.0
    c.liveness.probe_period = 2.0
    c.liveness.num_missed_probes_limit = 10
    c.tensor.handoff_fence_timeout = 60.0
    return c


def _check_cluster(cluster, history, what: str) -> dict:
    """Every player and game row of the cluster against the numpy oracle
    of ``history`` (one ``(games, scores, ticks, last_tick)`` per load
    phase): players' heartbeats and game exact, games' updates exact and
    total_score within twice Higham's bound; no key live on two silos.
    ``last_heartbeat`` is exact on the first silo, whose own players take
    each tick's local slice as its own batch; a silo fed by slabs may
    merge several ticks' slabs into one batch (the engine coalesces
    consecutive host batches, as the JAX engine does), and a SET of
    duplicate rows keeps any one of their writers, so there it lies
    within the phase's ticks."""
    players = np.arange(PLAYERS, dtype=np.int64)
    hb = sum(h[2] for h in history)
    per_game = np.zeros(GAMES, np.int64)
    score_sum = np.zeros(GAMES, np.float64)
    for games, scores, ticks, _ in history:
        per_game += np.bincount(games, minlength=GAMES) * ticks
        score_sum += np.bincount(games, weights=scores.astype(np.float64),
                                 minlength=GAMES) * ticks
    final_games, last_tick = history[-1][0], history[-1][3]
    seen = {"PresenceGrain": [], "GameGrain": []}
    cols = {"PresenceGrain": {}, "GameGrain": {}}
    first_silo = []
    for i, s in enumerate(cluster.silos):
        for type_name in seen:
            arena = s.tensor_engine.arenas.get(type_name)
            if arena is None or not arena.live_count:
                continue
            keys = arena.keys()
            rows, _ = arena.lookup_rows(keys)
            seen[type_name].append(keys)
            if type_name == "PresenceGrain":
                first_silo.append(np.full(len(keys), i == 0))
            for c, v in arena.state.items():
                cols[type_name].setdefault(c, []).append(
                    v.cpu().numpy()[rows])
    per_silo = {}
    for type_name, parts in seen.items():
        keys = np.concatenate(parts)
        require(len(np.unique(keys)) == len(keys),
                f"{what}: a {type_name} key is live on two silos")
        order = np.argsort(keys)
        per_silo[type_name] = [len(p) for p in parts]
        cols[type_name] = {c: np.concatenate(v)[order]
                           for c, v in cols[type_name].items()}
        seen[type_name] = keys[order]
        if type_name == "PresenceGrain":
            first_silo = np.concatenate(first_silo)[order]
    require(np.array_equal(seen["PresenceGrain"], players),
            f"{what}: players live")
    p = cols["PresenceGrain"]
    require(bool(np.all(p["heartbeats"] == hb)), f"{what}: heartbeats")
    lh = p["last_heartbeat"]
    require(bool(np.all(lh[first_silo] == last_tick)
                 and np.all((lh >= 1) & (lh <= last_tick))),
            f"{what}: last_heartbeat")
    require(np.array_equal(p["game"], final_games), f"{what}: game")
    present = np.flatnonzero(per_game > 0)
    require(np.array_equal(seen["GameGrain"], present), f"{what}: games live")
    g = cols["GameGrain"]
    require(np.array_equal(g["updates"], per_game[present]),
            f"{what}: updates")
    total = g["total_score"].astype(np.float64)
    tol = 2 * g["updates"] * 2.0**-24 * score_sum[present]
    err = np.abs(total - score_sum[present])
    require(bool(np.all(np.isfinite(total)) and np.all(err <= tol)),
            f"{what}: total_score off by {err.max()}")
    return per_silo


class _SiloSpans:
    """Host seconds per silo, and with ``trace`` a ``torch.profiler``
    range named after the silo, around its engine's ticks and miss
    drains, its cluster injector's inject (K22 and the one copy off the
    card) and its router's partitions, slab arrivals and slab flushes
    (the codec's encode and decode run in the sender's flush).  Spans do
    not nest: a call inside an open span stays in it."""

    def __init__(self, cluster, trace: bool = False):
        from orleans_tpu_torch.tensor import router as trouter

        self.trace = trace
        self.host = {s.name: 0.0 for s in cluster.silos}
        self._undo = []
        for s in cluster.silos:
            depth = [0]
            for obj, name in ((s.tensor_engine, "run_tick"),
                              (s.tensor_engine, "_drain_checks"),
                              (s.vector_router, "flush_slabs"),
                              (s.vector_router, "partition"),
                              (s.vector_router, "_inject_local")):
                self._wrap(obj, name, s.name, depth)
        cls = trouter.ClusterInjector
        orig = cls.inject
        spans = self

        def inject(inj, *a, **k):
            return spans._span(inj.router.silo.name, [0],
                               lambda: orig(inj, *a, **k))

        cls.inject = inject
        self._undo.append(lambda: setattr(cls, "inject", orig))

    def _span(self, silo: str, depth, call):
        from torch.profiler import record_function

        if depth[0]:
            return call()
        depth[0] += 1
        t0 = time.perf_counter()
        try:
            if self.trace:
                with record_function(f"silo:{silo}"):
                    return call()
            return call()
        finally:
            self.host[silo] += time.perf_counter() - t0
            depth[0] -= 1

    def _wrap(self, obj, name, silo, depth):
        fn = getattr(obj, name)

        def wrapped(*a, **k):
            return self._span(silo, depth, lambda: fn(*a, **k))

        setattr(obj, name, wrapped)
        self._undo.append(lambda: delattr(obj, name))

    def close(self):
        for undo in reversed(self._undo):
            undo()
        self._undo = []

    def per_tick_ms(self, ticks: int) -> dict:
        return {k: 1e3 * v / ticks for k, v in self.host.items()}


def _silo_device_ms(prof, cluster, ticks: int) -> dict:
    """Device ms per tick per silo: the kernels and copies enqueued inside
    each silo's CPU-side ranges (the trace's GPU-side annotation spans,
    which count idle gaps, are left out), and the trace's whole device
    time per tick."""
    from torch.autograd import DeviceType

    out = {s.name: 0.0 for s in cluster.silos}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("silo:"):
            out[e.name[5:]] += e.device_time_total / 1e3 / ticks
    out["trace"] = sum(_device_us(e) for e in prof.key_averages()
                       if not e.key.startswith("silo:")) / 1e3 / ticks
    return out


def _router_totals(cluster) -> dict:
    out = {"messages_shipped": 0, "slab_fragments": 0, "slab_frames": 0,
           "grains_migrated_out": 0, "grains_adopted": 0,
           "adopt_conflicts": 0, "messages_dropped": 0}
    for s in cluster.silos:
        snap = s.vector_router.snapshot()
        for k in out:
            out[k] += snap[k]
    f = cluster.fabric
    out.update(slab_frames_carried=f.slab_frames_carried,
               slab_bytes=f.slab_bytes, bytes_carried=f.bytes_carried,
               slab_codec_seconds=f.slab_codec_seconds)
    return out


def _delta(end: dict, base: dict) -> dict:
    return {k: end[k] - base[k] for k in end}


async def cluster_presence(dev, card: str) -> dict:
    """Presence 1M/10k on a 2-silo port cluster on the card: a warm-up,
    20 timed ticks through ``run_presence_load``'s cluster injector with
    device payloads (K22 every inject, remote games missing through K6
    and shipped), 8 traced ticks split by silo, auto-fused windows of
    each silo's own players on its own games, then a third silo joins
    (handoff push, fence) and 10 more ticks split 3 ways; exact against
    numpy after each stage."""
    from orleans_tpu_torch.samples.presence import (
        presence_inputs,
        run_presence_load,
    )
    from orleans_tpu_torch.testing import TestingCluster
    from torch.profiler import ProfilerActivity, profile

    out = {}
    _, games, scores = presence_inputs(PLAYERS, GAMES, seed=0)
    cluster = await TestingCluster(n_silos=2, device=dev,
                                   config_factory=_bench_silo_config).start()
    try:
        a, b = cluster.silos
        for s in cluster.silos:
            s.tensor_engine.config.auto_fusion_ticks = 0  # unfused stages
        history = []
        await run_presence_load(a.tensor_engine, n_players=PLAYERS,
                                n_games=GAMES, n_ticks=WARM_TICKS)
        await cluster.quiesce_engines()
        history.append((games, scores, WARM_TICKS, WARM_TICKS))
        _check_cluster(cluster, history, "cluster warm-up")

        base = _router_totals(cluster)
        spans = _SiloSpans(cluster)
        t0 = time.perf_counter()
        try:
            stats = await run_presence_load(a.tensor_engine,
                                            n_players=PLAYERS,
                                            n_games=GAMES, n_ticks=TICKS)
            await cluster.quiesce_engines()
            torch.cuda.synchronize()
        finally:
            spans.close()
        dt = time.perf_counter() - t0
        d = _delta(_router_totals(cluster), base)
        history.append((games, scores, TICKS, TICKS))
        split = _check_cluster(cluster, history, "cluster 20 ticks")
        out["unfused"] = {
            "ticks": TICKS, "seconds": dt,
            "messages_per_sec": 2 * PLAYERS * TICKS / dt,
            "loader_messages_per_sec": stats["messages_per_sec"],
            "cross_silo_messages": d["messages_shipped"],
            "cross_silo_messages_per_sec": d["messages_shipped"] / dt,
            "slab_frames": d["slab_frames_carried"],
            "slab_bytes": d["slab_bytes"],
            "codec_ms_per_slab": 1e3 * d["slab_codec_seconds"]
            / max(1, d["slab_frames_carried"]),
            "host_ms_per_tick": spans.per_tick_ms(TICKS),
            "rows_per_silo": split}

        spans = _SiloSpans(cluster, trace=True)
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                await run_presence_load(a.tensor_engine, n_players=PLAYERS,
                                        n_games=GAMES, n_ticks=TRACE_TICKS)
                await cluster.quiesce_engines()
                torch.cuda.synchronize()
        finally:
            spans.close()
        history.append((games, scores, TRACE_TICKS, TRACE_TICKS))
        _check_cluster(cluster, history, "cluster traced ticks")
        out["traced"] = {"device_ms_per_tick": _silo_device_ms(
            prof, cluster, TRACE_TICKS),
            "host_ms_per_tick": spans.per_tick_ms(TRACE_TICKS)}

        # fused: each silo's own players on its own games (no remote emit,
        # so no miss pass), both auto-fusers at the default config
        players = np.arange(PLAYERS, dtype=np.int64)
        game_keys = np.arange(GAMES, dtype=np.int64)
        fused_games = games.copy()
        injectors = []
        for s in cluster.silos:
            s.tensor_engine.config.auto_fusion_ticks = 16
            own_p = s.vector_router.partition("PresenceGrain", players)[0]
            own_g = game_keys[s.vector_router.partition(
                "GameGrain", game_keys)[0]]
            idx = np.flatnonzero(own_p)
            fused_games[idx] = own_g[idx % len(own_g)].astype(np.int32)
            inj = s.tensor_engine.make_injector("PresenceGrain", "heartbeat",
                                                players[idx])
            require(inj._all_local, "fused arm: a silo's own key set split")
            injectors.append((s, inj, {
                "game": torch.from_numpy(fused_games[idx]).to(dev),
                "score": torch.from_numpy(scores[idx]).to(dev)}))
        t0 = time.perf_counter()
        for tick in range(1, FUSED_CLUSTER_TICKS + 1):
            for s, inj, args in injectors:
                inj.inject({**args, "tick": np.int32(tick)})
            for s, _, _ in injectors:
                await s.tensor_engine.drain_queues()
        await cluster.quiesce_engines()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        history.append((fused_games, scores, FUSED_CLUSTER_TICKS,
                        FUSED_CLUSTER_TICKS))
        _check_cluster(cluster, history, "cluster fused")
        fused = {s.name: s.tensor_engine.autofuser.snapshot()
                 for s in cluster.silos}
        require(all(f["windows_run"] > 0 for f in fused.values()),
                f"fused arm: a silo ran no fused window: {fused}")
        out["fused"] = {"ticks": FUSED_CLUSTER_TICKS, "seconds": dt,
                        "messages_per_sec": 2 * PLAYERS
                        * FUSED_CLUSTER_TICKS / dt, "autofuse": fused}

        # a third silo joins: the handoff pushes the strays, the fence
        # settles, the load goes on split 3 ways
        base = _router_totals(cluster)
        t0 = time.perf_counter()
        await cluster.start_additional_silo()
        await cluster.wait_for_liveness_convergence(timeout=120.0)
        while not all(s.vector_router.handoff_settled()
                      for s in cluster.silos):
            await asyncio.sleep(0.005)
        await cluster.quiesce_engines()
        torch.cuda.synchronize()
        handoff_s = time.perf_counter() - t0
        moved = _delta(_router_totals(cluster), base)
        require(moved["adopt_conflicts"] == 0
                and moved["grains_adopted"] == moved["grains_migrated_out"]
                and moved["grains_migrated_out"] > 0,
                f"join handoff: {moved}")
        split = _check_cluster(cluster, history, "after the join")
        for s in cluster.silos:
            s.tensor_engine.config.auto_fusion_ticks = 0
        spans = _SiloSpans(cluster)
        t0 = time.perf_counter()
        try:
            await run_presence_load(a.tensor_engine, n_players=PLAYERS,
                                    n_games=GAMES, n_ticks=JOIN_TICKS)
            await cluster.quiesce_engines()
            torch.cuda.synchronize()
        finally:
            spans.close()
        dt = time.perf_counter() - t0
        history.append((games, scores, JOIN_TICKS, JOIN_TICKS))
        split3 = _check_cluster(cluster, history, "3 silos")
        require(all(len(v) == 3 and min(v) > 0 for v in split3.values()),
                f"3 silos: a silo holds no rows {split3}")
        out["join"] = {"handoff_seconds": handoff_s,
                       "migrated_rows": moved["grains_migrated_out"],
                       "adopt_bytes": moved["bytes_carried"],
                       "rows_per_silo_after_handoff": split,
                       "rows_per_silo": split3, "ticks": JOIN_TICKS,
                       "seconds": dt,
                       "host_ms_per_tick": spans.per_tick_ms(JOIN_TICKS),
                       "messages_per_sec": 2 * PLAYERS * JOIN_TICKS / dt}
        out["players"], out["games"] = PLAYERS, GAMES
        return out
    finally:
        await cluster.stop()


async def cluster_fragmented(dev) -> dict:
    """bench.py ``_cluster_presence``'s drive on a 2-silo port cluster on
    the card: each tick's heartbeats as 8 uneven host fragments (cuts at
    ``np.geomspace(64, n, 8)``), sender aggregation on, 2 warm and 10
    timed ticks, exact."""
    from orleans_tpu_torch.testing import TestingCluster

    cluster = await TestingCluster(n_silos=2, device=dev,
                                   config_factory=_bench_silo_config).start()
    try:
        a = cluster.silos[0]
        keys = np.arange(PLAYERS, dtype=np.int64)
        games = (keys % GAMES).astype(np.int32)
        scores = np.ones(PLAYERS, np.float32)
        cuts = np.unique(np.concatenate(
            [[0], np.geomspace(64, PLAYERS, 8).astype(int), [PLAYERS]]))
        spans = [(int(lo), int(hi)) for lo, hi in zip(cuts[:-1], cuts[1:])
                 if hi > lo]

        async def drive(tick: int) -> None:
            for lo, hi in spans:
                a.tensor_engine.send_batch(
                    "PresenceGrain", "heartbeat", keys[lo:hi],
                    {"game": games[lo:hi], "score": scores[lo:hi],
                     "tick": np.full(hi - lo, tick, np.int32)})
            await a.tensor_engine.drain_queues()

        for t in range(2):
            await drive(t + 1)
        await cluster.quiesce_engines()
        base = _router_totals(cluster)
        t0 = time.perf_counter()
        for t in range(FRAG_TICKS):
            await drive(3 + t)
        await cluster.quiesce_engines()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        d = _delta(_router_totals(cluster), base)
        updates = sum(int(s.tensor_engine.arenas["GameGrain"].state[
            "updates"].sum()) for s in cluster.silos)
        require(updates == PLAYERS * (2 + FRAG_TICKS),
                f"fragmented drive: {updates} updates")
        return {"ticks": FRAG_TICKS, "fragments_per_tick": len(spans),
                "seconds": dt,
                "messages_per_sec": 2 * PLAYERS * FRAG_TICKS / dt,
                "cross_silo_messages_per_sec": d["messages_shipped"] / dt,
                "slab_fragments": d["slab_fragments"],
                "slab_frames": d["slab_frames"],
                "slab_merge_ratio": d["slab_fragments"]
                / max(1, d["slab_frames"]),
                "codec_bytes": d["bytes_carried"],
                "slab_bytes": d["slab_bytes"],
                "codec_ms_per_slab": 1e3 * d["slab_codec_seconds"]
                / max(1, d["slab_frames_carried"])}
    finally:
        await cluster.stop()


def drive_cluster_path(dev, card: str, timer) -> dict:
    """Phase 12: K22 against its plain version; cross-silo Presence 1M/10k
    on a 2-silo cluster on the card, a third silo joining; the fragmented
    send_batch drive.  Launch counts zeroed before each arm and read
    after it."""
    from orleans_tpu_torch.kernels import _build

    out = {"counts": {}, "report": {}}
    out["kernels"] = check_router_kernels(dev, timer, card)
    gc.collect()
    torch.cuda.empty_cache()
    arms = {}
    for name, fn, kernels in (
            ("cluster_presence", lambda: cluster_presence(dev, card),
             CLUSTER_KERNELS),
            ("cluster_fragmented", lambda: cluster_fragmented(dev),
             ("miss_keys", "seg_sum", "row_scatter"))):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        arms[name] = asyncio.run(fn())
        arms[name]["arm_seconds"] = time.perf_counter() - t0
        out["counts"][name] = _build.launch_counts()
        out["report"][name] = _build.launch_report()
        require_launched(out["counts"][name], name, kernels)
        gc.collect()
        torch.cuda.empty_cache()
    out["arms"] = arms
    p, f = arms["cluster_presence"], arms["cluster_fragmented"]
    u, j = p["unfused"], p["join"]
    print(f"cross-silo Presence {PLAYERS}/{GAMES} on 2 silos: "
          f"{u['messages_per_sec']:.0f} messages/s over {TICKS} ticks "
          f"({u['cross_silo_messages_per_sec']:.0f} cross-silo messages/s, "
          f"{u['slab_frames']} slab frames, {u['slab_bytes']} bytes, codec "
          f"{u['codec_ms_per_slab']:.3f} ms per slab), exact; on {card}",
          flush=True)
    tr = p["traced"]
    for name, host in u["host_ms_per_tick"].items():
        print(f"  {name}: host {host:.2f} ms per tick over the timed ticks "
              f"({tr['host_ms_per_tick'][name]:.2f} traced), device "
              f"{tr['device_ms_per_tick'][name]:.4f} ms per tick (traced, "
              f"{TRACE_TICKS} ticks)", flush=True)
    print(f"  the trace's device time: "
          f"{tr['device_ms_per_tick']['trace']:.4f} ms per tick; "
          f"fused arm {p['fused']['messages_per_sec']:.0f} messages/s, "
          f"{p['fused']['autofuse']}; on {card}", flush=True)
    print(f"third silo joins: handoff {j['handoff_seconds']:.3f} s wall, "
          f"{j['migrated_rows']} rows pushed, rows per silo "
          f"{j['rows_per_silo']}, then {j['messages_per_sec']:.0f} "
          f"messages/s over {JOIN_TICKS} ticks split 3 ways (host ms per "
          f"tick by silo {j['host_ms_per_tick']}), exact; on {card}",
          flush=True)
    print(f"fragmented send_batch drive: {f['fragments_per_tick']} "
          f"fragments a tick, merge ratio {f['slab_merge_ratio']:.3f} "
          f"({f['slab_fragments']} fragments, {f['slab_frames']} frames), "
          f"{f['codec_bytes']} bytes through the codec, "
          f"{f['messages_per_sec']:.0f} messages/s, exact; on {card}",
          flush=True)
    print("cluster arms: " + json.dumps(arms, default=str), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 13: shard blocks and the cross-shard exchange
# ---------------------------------------------------------------------------

def _ex_engine(dev, **cfg):
    """A routing engine over ``EX_BLOCKS`` shard blocks on the card at the
    default config (ledger and attribution plane on), the legacy layout
    pinned as bench.py ``_multichip_tier`` pins it, auto-fusion off (the
    sample drives its fused windows by hand)."""
    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.samples import routing  # noqa: F401
    from orleans_tpu_torch.tensor.engine import TensorEngine
    from orleans_tpu_torch.tensor.mesh import ShardMesh

    cfg.setdefault("exchange_per_dest", "never")
    return TensorEngine(mesh=ShardMesh(EX_BLOCKS, dev), device=dev,
                        config=TensorEngineConfig(auto_fusion_ticks=0,
                                                  **cfg))


def _ex_sink_lanes(rng, n_lanes: int, L: int, sc: int, ratio: float):
    """Lanes laid out as the sink leg's (chunk s = lane // L holds the
    emits of block s's sources): a lane crosses to a random other block
    with probability ``ratio``; 3% padding and 2% masked lanes."""
    n = EX_BLOCKS
    chunk = np.arange(n_lanes) // L
    cross = rng.random(n_lanes) < ratio
    other = (chunk + rng.integers(1, n, n_lanes)) % n
    dest = np.where(cross, other, chunk)
    rows = (dest * sc + rng.integers(0, sc, n_lanes)).astype(np.int32)
    rows[rng.random(n_lanes) < 0.03] = -1
    return rows, rng.random(n_lanes) >= 0.02


def check_exchange_kernels(dev, timer, card: str) -> dict:
    """K23 (both modes) and K24 (both layouts) against their plain
    versions, bit for bit, at the sweep's shapes: 4,000,000 lanes padded to
    4,194,304 over 8 blocks of 131,072 rows (the sink arena at 524,288
    sinks), laid out as the sink leg at ratio 0.5, with the caps the
    sweep's estimator grants from this demand (the legacy grant, the same
    halved so lanes overflow, the per-destination grants and receive rung,
    and that rung halved so the receive side overflows); payload leaves of
    4 bytes (float32), 8 bytes (int64) and one [m, 2] int32.  Each kernel
    timed beside its bound and its plain version; no single PyTorch call
    computes either, so the library figure is a composite (noted)."""
    from orleans_tpu_torch.kernels import exchange as kx
    from orleans_tpu_torch.tensor.exchange import _SiteEstimator, ladder_ceil

    n, m = EX_BLOCKS, EX_SOURCES
    L = ladder_ceil(-(-m // n))
    sc = 2 * (EX_SINKS // n)          # the sink arena's block after reserve
    rng = np.random.default_rng(13013)
    rows_np, mask_np = _ex_sink_lanes(rng, m, L, sc, 0.5)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rows, mask = t(rows_np), t(mask_np)
    leaves = [t(rng.integers(1, 8, m).astype(np.float32)),
              t(rng.integers(-2**62, 2**62, m, dtype=np.int64)),
              t(rng.integers(0, 9, (m, 2)).astype(np.int32))]
    out = {}
    for mode in ("probe", "cap0"):
        got = kx.exchange_classify(rows, mask, sc, L, n, mode)
        want = kx.exchange_classify_plain(rows, mask, sc, L, n, mode)
        pairs = zip(got, want) if mode == "cap0" else [(got, want)]
        require(all(torch.equal(a, b) for a, b in pairs),
                f"exchange_classify ({mode}) != plain")
    stats = kx.exchange_classify(rows, mask, sc, L, n, "probe").cpu().numpy()
    # the per-(source, destination) demand from a fitting legacy run
    fit = kx.exchange_buckets_plain(rows, mask, leaves[:1], sc, L, n, cap=L)
    need = fit[4].cpu().numpy()[3:]
    est = _SiteEstimator(n)
    est.observe(need[:n], 1.5, 4, inbound=need[n:])
    cap = min(L, int(est.grant))
    caps = [min(L, int(c)) for c in est.grants]
    R = max(1, ladder_ceil(min(int(est.recv_grant), n * L)))
    plans = {"legacy": dict(cap=cap), "legacy_overflow": dict(cap=cap // 2),
             "perdest": dict(caps=caps, R=R),
             "perdest_recv_overflow": dict(caps=caps, R=R // 2)}
    for name, plan in plans.items():
        got = kx.exchange_buckets(rows, mask, leaves, sc, L, n, **plan)
        want = kx.exchange_buckets_plain(rows, mask, leaves, sc, L, n,
                                         **plan)
        same = torch.equal(got[0], want[0]) and all(
            torch.equal(a, b) for a, b in zip(got[1], want[1])) and all(
            torch.equal(a, b) for a, b in zip(got[2:], want[2:]))
        require(same, f"exchange_buckets ({name}) != plain")
        dropped = int(want[4][1])
        require((dropped > 0) == name.endswith("overflow"),
                f"exchange_buckets ({name}): {dropped} lanes dropped")
    # one hot destination: every valid lane bound for block n - 1 (the
    # other chunks' lanes all cross to it, its own stay local)
    hot = t(np.where(rows_np >= 0, (n - 1) * sc + rows_np % sc, -1)
            .astype(np.int32))
    for name, plan in (("hot legacy", dict(cap=cap)),
                       ("hot per-dest", dict(caps=caps, R=R))):
        got = kx.exchange_buckets(hot, mask, leaves, sc, L, n, **plan)
        want = kx.exchange_buckets_plain(hot, mask, leaves, sc, L, n,
                                         **plan)
        require(torch.equal(got[0], want[0]) and all(
            torch.equal(a, b) for a, b in zip(got[1], want[1])) and all(
            torch.equal(a, b) for a, b in zip(got[2:], want[2:])),
            f"exchange_buckets ({name}) != plain")
    # timing: K23 probe and cap-0 at the path's lanes; K24 at the legacy
    # grant (the sweep's layout) with the path's two leaves (v, count)
    path_leaves = [leaves[0], t(np.ones(m, np.int32))]
    valid = int(stats[2])
    leaf_b = 8
    W = L + n * cap
    b24 = m * (4 + 1 + leaf_b) + n * W * (4 + 1 + leaf_b) + m
    lanes_p = n * L

    def k23_composite():
        chunk = torch.arange(lanes_p, device=dev) // L
        r = torch.nn.functional.pad(rows, (0, lanes_p - m), value=-1)
        mk = torch.nn.functional.pad(mask, (0, lanes_p - m))
        ok = mk & (r >= 0)
        dest = torch.where(ok, r // sc, n)
        code = torch.where(dest == chunk, n, dest)
        return torch.bincount(code, minlength=n + 1)

    sdest = torch.where(rows >= 0, rows.long() // sc, n)
    sdest = torch.nn.functional.pad(sdest, (0, lanes_p - m), value=n) \
        .view(n, L)
    out_rows = torch.empty(n * W, dtype=torch.int32, device=dev)
    slot = torch.randperm(n * W, device=dev)[:lanes_p]

    def k24_composite():
        order = torch.argsort(sdest, dim=1, stable=True)
        flat = (order + torch.arange(n, device=dev).view(n, 1) * L) \
            .view(-1).clamp_(max=m - 1)
        out_rows.index_put_((slot,), rows[flat])
        for x in path_leaves:
            x.index_select(0, flat)
        return order

    for name, fn, plain, composite, bytes_moved, what in (
            ("exchange_classify",
             lambda: kx.exchange_classify(rows, mask, sc, L, n, "probe"),
             lambda: kx.exchange_classify_plain(rows, mask, sc, L, n,
                                                "probe"),
             k23_composite, 5 * m,
             "elementwise classification + torch.bincount"),
            ("exchange_buckets",
             lambda: kx.exchange_buckets(rows, mask, path_leaves, sc, L, n,
                                         cap=cap),
             lambda: kx.exchange_buckets_plain(rows, mask, path_leaves, sc,
                                               L, n, cap=cap),
             k24_composite, b24,
             "stable torch.argsort per chunk + index_put_ of the rows + "
             "index_select of each leaf")):
        r = dict(bound=bound(bytes_moved), **measure(timer, fn, plain, None))
        r["composite_ms"] = timer(composite)
        r.update(max_abs_err=0, library=None, library_note=(
            f"no single PyTorch call: {what} take {r['composite_ms']:.4f} "
            f"ms"), per={"lanes": m, "padded_lanes": lanes_p, "L": L,
                         "blocks": n, "shard_capacity": sc})
        out[name] = r
    out["exchange_classify"]["cap0_ms"] = timer(
        lambda: kx.exchange_classify(rows, mask, sc, L, n, "cap0"))
    out["exchange_classify"]["cap0_bound_ms"] = bound(5 * m
                                                      + 6 * lanes_p)[0]
    out["exchange_buckets"]["per"].update(
        cap=cap, W=W, caps=caps, R=R, valid_lanes=valid,
        perdest_ms=timer(lambda: kx.exchange_buckets(
            rows, mask, path_leaves, sc, L, n, caps=caps, R=R)),
        perdest_bound_ms=bound(m * 13 + n * (L + R) * 13 + m)[0])
    # K24's launches apart (torch.profiler, device µs a call by kernel)
    out["exchange_buckets"]["per"]["split_us"] = {
        "legacy": _split_us(lambda: kx.exchange_buckets(
            rows, mask, path_leaves, sc, L, n, cap=cap)),
        "perdest": _split_us(lambda: kx.exchange_buckets(
            rows, mask, path_leaves, sc, L, n, caps=caps, R=R))}
    c, b = out["exchange_classify"], out["exchange_buckets"]
    for layout, split in b["per"]["split_us"].items():
        print(f"kernel exchange_buckets {layout} split (device µs a call): "
              + (", ".join(f"{k} {v:.2f}" for k, v in split.items())
                 or "not measured (no device time in the traces)")
              + f"; on {card}", flush=True)
    print(f"kernel exchange_classify: probe {c['ms']:.4f} ms on the device "
          f"(plain {c['plain_ms']:.4f}, composite {c['composite_ms']:.4f}, "
          f"bound {c['bound'][0]:.4f} by {c['bound'][1]}), cap-0 "
          f"{c['cap0_ms']:.4f} (bound {c['cap0_bound_ms']:.4f}); {m} lanes "
          f"over {n} blocks, L {L}; on {card}", flush=True)
    print(f"kernel exchange_buckets: legacy cap {cap} (W {W}) {b['ms']:.4f} "
          f"ms on the device, host {b['host_ms']:.4f} (plain "
          f"{b['plain_ms']:.4f}, composite {b['composite_ms']:.4f}, bound "
          f"{b['bound'][0]:.4f} by {b['bound'][1]}); per-destination caps "
          f"{caps} R {R} {b['per']['perdest_ms']:.4f} ms (bound "
          f"{b['per']['perdest_bound_ms']:.4f}); both layouts and both "
          f"overflows bit-exact with 4-byte, 8-byte and 2-D leaves; on "
          f"{card}", flush=True)
    return out


def _sink_columns(arena, idx) -> dict:
    """The sink rows ``idx``'s ``total`` and ``received`` on the host."""
    return {c: arena.state[c].index_select(0, idx).cpu().numpy()
            for c in ("total", "received")}


class _SinkOracle:
    """The expected sink state of a run that may mix ratios and tick
    counts: ``expected_sink_state`` summed over what was driven."""

    def __init__(self, sources, sinks, values):
        self.sources, self.sinks, self.values = sources, sinks, values
        self.total = np.zeros(len(sinks), np.float64)
        self.recv = np.zeros(len(sinks), np.int64)

    def add(self, dst, ticks: int) -> None:
        from orleans_tpu_torch.samples import routing

        t, r = routing.expected_sink_state(self.sources, dst, self.values,
                                           self.sinks, ticks)
        self.total += t
        self.recv += r

    def check(self, engine, what: str) -> None:
        arena = engine.arena_for("RouteSink")
        rows, found = arena.lookup_rows(self.sinks)
        require(found.all(), f"{what}: a sink is not live")
        idx = torch.from_numpy(rows.astype(np.int64)).to(engine.device)
        got = _sink_columns(arena, idx)
        require(np.array_equal(got["received"], self.recv),
                f"{what}: received != expected_sink_state")
        # integer-valued float32 sums, all below 2**24: exact
        require(float(self.total.max()) < 2**24, f"{what}: sums inexact")
        require(np.array_equal(got["total"].astype(np.float64), self.total),
                f"{what}: total != expected_sink_state")


def _ex_counts(engine) -> dict:
    x = engine.stats()["exchange"]
    return {k: x[k] for k in ("cross_shard_msgs", "delivered_msgs",
                              "dropped_msgs", "redeliveries",
                              "exchanges_run")}


def _ex_delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


def _ex_tick_ms(engine, sources, dst_d, values_d, oracle, dst,
                n_blocks: int = 2) -> tuple:
    """Device and host ms of one steady unfused tick: held timing over
    blocks of 4 ticks through an injector (parked checks drained before
    each block); the ticks join the oracle."""
    inj = engine.make_injector("RouteSource", "send", sources)
    count = [0]

    def block():
        for _ in range(4):
            inj.inject({"dst": dst_d, "v": values_d,
                        "tick": np.int32(count[0])})
            count[0] += 1
            engine.run_tick()
            for _ in range(engine.config.max_rounds_per_tick):
                if not any(engine.queues.values()):
                    break
                engine.run_tick()

    dev_ms, host_ms = held_device_ms(block, reps=n_blocks,
                                     prepare=engine._drain_checks)
    asyncio.run(engine.flush())
    oracle.add(dst, count[0])
    return dev_ms / 4, host_ms / 4


def _ex_window_ms(engine, sources, dst_d, values_d, oracle, dst) -> float:
    """Device ms of one steady fused window of ``EX_WINDOW`` ticks (a
    program built and verified first, then two replays held behind the
    spin kernel); the ticks join the oracle."""
    prog = engine.fuse_ticks("RouteSource", "send", sources)
    static = {"dst": dst_d, "v": values_d}
    ticks = torch.arange(EX_WINDOW, dtype=torch.int32, device=engine.device)
    prog.run({"tick": ticks}, static_args=static)
    require(prog.verify() == 0, "a timing window missed")
    ms, _host = held_device_ms(lambda: prog.run({"tick": ticks},
                                                static_args=static), reps=2)
    require(prog.verify() == 0, "a timing window missed")
    oracle.add(dst, 3 * EX_WINDOW)
    return ms


def _ex_sweep_arm(dev, card, arm: str, fused: bool, shared: dict) -> dict:
    """One arm of the ratio sweep: ratios in descending order (a grant
    sized at a higher ratio never undersizes a lower one, so the count
    identities below hold with no overflow), each through
    ``run_routing_load`` (3 warm and 12 timed unfused ticks, or 2 warm and
    3 timed windows of 4) on one engine — except the structured fused arm,
    which takes a fresh engine per ratio as bench.py does (its windows
    rebuild at every grant move, and a shrinking grant of an earlier ratio
    would move inside the timed windows); the sink state exact after
    every ratio; on the structured unfused arm the sink leg crosses
    exactly round(ratio * n) lanes a tick (the source leg where its lane
    chunk is not its home block), every lane delivered, none dropped.  At
    ratio 0.5 the device ms of a tick (unfused) or a window (fused)."""
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.samples import routing

    cfg = {"always": dict(exchange_structured="always"),
           "off": dict(cross_shard_exchange=False),
           "auto": dict(exchange_structured="auto")}[arm]
    fresh_each = fused and arm == "always"
    sources, sinks, values = shared["sources"], shared["sinks"], \
        shared["values"]
    values_d = shared["values_d"]
    out = {"ratios": {}}
    eng = None
    _build.reset_launch_counts()
    for ratio in EX_RATIOS:
        if eng is None or fresh_each:
            eng = None
            gc.collect()
            eng = _ex_engine(dev, **cfg)
            oracle = _SinkOracle(sources, sinks, values)
        dst = shared["dst"][ratio]
        x0 = _ex_counts(eng) if eng.exchange is not None else None
        t0 = time.perf_counter()
        st = asyncio.run(routing.run_routing_load(
            eng, EX_SOURCES, EX_SINKS, ratio, n_ticks=EX_TICKS,
            fused_window=EX_WINDOW if fused else 0))
        wall = time.perf_counter() - t0
        oracle.add(dst, st["total_ticks"])
        oracle.check(eng, f"{arm} {'fused' if fused else 'unfused'} "
                          f"ratio {ratio}")
        row = dict(messages_per_sec=st["messages_per_sec"],
                   seconds=st["seconds"], run_wall_s=wall,
                   total_ticks=st["total_ticks"],
                   bucket_utilization=st["bucket_utilization"])
        if x0 is not None:
            d = _ex_delta(x0, _ex_counts(eng))
            row.update(d)
            if arm == "always" and not fused:
                ticks = st["total_ticks"]
                want = (shared["src_cross"]
                        + int(round(ratio * EX_SOURCES))) * ticks
                require(d["cross_shard_msgs"] == want,
                        f"ratio {ratio}: {d['cross_shard_msgs']} cross-shard "
                        f"messages, want {want}")
                require(d["delivered_msgs"] == 2 * EX_SOURCES * ticks
                        and d["dropped_msgs"] == 0,
                        f"ratio {ratio}: delivered {d['delivered_msgs']}, "
                        f"dropped {d['dropped_msgs']}")
                row["sink_leg_cross_per_tick"] = \
                    d["cross_shard_msgs"] // ticks - shared["src_cross"]
        if ratio == 0.5:
            dst_d = torch.from_numpy(dst.astype(np.int32)).to(dev)
            if fused:
                row["window_device_ms"] = _ex_window_ms(
                    eng, sources, dst_d, values_d, oracle, dst)
            else:
                row["tick_device_ms"], row["tick_host_ms"] = _ex_tick_ms(
                    eng, sources, dst_d, values_d, oracle, dst)
            oracle.check(eng, f"{arm} ratio 0.5 timing ticks")
        out["ratios"][ratio] = row
    out["counts"] = _build.launch_counts()
    out["report"] = _build.launch_report()
    c = out["counts"]
    if arm == "always":
        require(c["exchange_buckets"] > 0, f"{arm}: K24 never launched")
    elif arm == "auto":
        require(c["exchange_buckets"] == 0, "auto arm launched K24")
        require(c["exchange_classify"] > 0 or fused,
                "auto arm never probed (K23)")
    else:
        require(c["exchange_buckets"] == c["exchange_classify"] == 0,
                "the exchange-off arm launched K23 or K24")
    out["snapshot"] = eng.stats()["exchange"]
    out["engaged"] = None if eng.exchange is None else eng.exchange.engaged()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ex_extra_arms(dev, card: str, shared: dict) -> dict:
    """On a fresh structured engine (unfused): the sweep at ratio 0.9 to
    size the grants, then the per-destination layout at ratio 0.5
    (``exchange_per_dest="always"``, the plan must be per-destination),
    then the overflow arm — patience 1, ratio 0 shrinks the sink leg's
    grant to cap 0, and ratio 0.9 overflows it: the dropped lanes park
    and are delivered again with their original stamp (the ledger's
    RouteSink.recv histogram gains counts past bucket 0) — each exact."""
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.samples import routing

    eng = _ex_engine(dev, exchange_structured="always")
    oracle = _SinkOracle(shared["sources"], shared["sinks"],
                         shared["values"])
    out = {}

    def sweep(ratio: float, n_ticks: int, what: str) -> dict:
        x0 = _ex_counts(eng)
        st = asyncio.run(routing.run_routing_load(
            eng, EX_SOURCES, EX_SINKS, ratio, n_ticks=n_ticks))
        oracle.add(shared["dst"][ratio], st["total_ticks"])
        oracle.check(eng, what)
        return dict(_ex_delta(x0, _ex_counts(eng)),
                    messages_per_sec=st["messages_per_sec"],
                    total_ticks=st["total_ticks"])

    sweep(0.9, 4, "grant sizing at 0.9")
    _build.reset_launch_counts()
    eng.config.exchange_per_dest = "always"
    pd = sweep(0.5, EX_TICKS, "per-destination arm")
    site = ("RouteSink", "recv")
    require(any(isinstance(k[1], tuple) and k[1][0] == "pd"
                for k in eng.exchange._plans),
            "the per-destination arm never ran the per-destination layout")
    pd.update(counts=_build.launch_counts(),
              grants=eng.exchange.snapshot()["sites"].get("RouteSink.recv"))
    require(pd["counts"]["exchange_buckets"] > 0, "per-dest: no K24")
    out["per_dest"] = pd
    eng.config.exchange_per_dest = "never"
    eng.config.exchange_shrink_patience = 1
    hist0 = eng.ledger.snapshot().get("RouteSink.recv", {}).get("counts")
    _build.reset_launch_counts()
    calm = sweep(0.0, 4, "overflow arm, ratio 0")
    require(eng.exchange.grant_for(site) == 0,
            f"ratio 0 left the sink grant at {eng.exchange.grant_for(site)}")
    over = sweep(0.9, 4, "overflow arm, ratio 0.9")
    hist1 = eng.ledger.snapshot()["RouteSink.recv"]["counts"]
    late = sum(hist1[1:]) - (sum(hist0[1:]) if hist0 else 0)
    require(over["dropped_msgs"] > 0 and over["redeliveries"] > 0,
            f"overflow arm: {over}")
    require(late > 0, "overflow arm: no redelivered lane in the ledger "
            "past bucket 0")
    counts = _build.launch_counts()
    require(counts["exchange_classify"] > 0,
            "overflow arm: the cap-0 pass (K23) never ran")
    require(over["delivered_msgs"] == 2 * EX_SOURCES * over["total_ticks"],
            f"overflow arm: {over['delivered_msgs']} delivered")
    out["overflow"] = dict(over, calm=calm, ledger_late_lanes=late,
                           ledger_counts=hist1, counts=counts)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ex_migration_arm(dev, card: str, shared: dict) -> dict:
    """Live migration at ratio 0.5: 4 ticks, a fifth injected and still
    queued when 52,429 sinks (10%) and 4,096 sources move to random other
    blocks with pins, then 7 more ticks.  The sink state equals a
    never-migrated engine's driven alike and ``expected_sink_state``;
    every mover lies in its pinned block; the queued batch's cached
    source rows went stale at the epoch bump and were delivered through
    host re-resolution; the move's K13 gathers and K3 sets are counted."""
    from orleans_tpu_torch.kernels import _build

    sources, sinks = shared["sources"], shared["sinks"]
    dst = shared["dst"][0.5]
    dst_d = torch.from_numpy(dst.astype(np.int32)).to(dev)
    rng = np.random.default_rng(52429)
    movers = rng.choice(sinks, EX_MOVERS, replace=False)
    src_movers = rng.choice(sources, 4096, replace=False)
    out = {}
    states = {}
    for migrate in (True, False):
        eng = _ex_engine(dev, exchange_structured="always")
        eng.arena_for("RouteSource").reserve(EX_SOURCES)
        eng.arena_for("RouteSink").reserve(EX_SINKS)
        eng.arena_for("RouteSource").resolve_rows(sources)
        eng.arena_for("RouteSink").resolve_rows(sinks)
        inj = eng.make_injector("RouteSource", "send", sources)

        def tick(t: int, run: bool = True) -> None:
            inj.inject({"dst": dst_d, "v": shared["values_d"],
                        "tick": np.int32(t)})
            if run:
                asyncio.run(eng.drain_queues())

        for t in range(4):
            tick(t)
        asyncio.run(eng.flush())
        tick(4, run=False)  # in flight: queued with cached rows
        if migrate:
            sa = eng.arena_for("RouteSink")
            ra = eng.arena_for("RouteSource")
            home = sa.home_shards(movers)
            to = (home + rng.integers(1, EX_BLOCKS, len(movers))) % EX_BLOCKS
            src_to = (ra.home_shards(src_movers) + 1) % EX_BLOCKS
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            moved = eng.migrate_keys("RouteSink", movers, to)
            moved += eng.migrate_keys("RouteSource", src_movers, src_to)
            torch.cuda.synchronize()
            move_s = time.perf_counter() - t0
            mc = _build.launch_counts()
            require(moved == EX_MOVERS + 4096, f"moved {moved}")
            require(mc["gather_rows"] > 0 and mc["row_scatter"] > 0,
                    f"the move's gathers/scatters uncounted: {mc}")
            rows, found = sa.lookup_rows(movers)
            require(found.all() and np.array_equal(
                rows // sa.shard_capacity, to), "a mover off its block")
            require(np.array_equal(sa.home_shards(movers), to),
                    "a mover's pin is missing")
            out.update(moved=moved, move_s=move_s,
                       move_launches={k: mc[k] for k in
                                      ("gather_rows", "row_scatter")})
        asyncio.run(eng.drain_queues())
        for t in range(5, 12):
            tick(t)
        asyncio.run(eng.flush())
        oracle = _SinkOracle(sources, sinks, shared["values"])
        oracle.add(dst, 12)
        oracle.check(eng, f"migration arm (migrated={migrate})")
        sa = eng.arena_for("RouteSink")
        rows = sa.lookup_rows(sinks)[0]
        states[migrate] = _sink_columns(
            sa, torch.from_numpy(rows.astype(np.int64)).to(dev))
        # the queued tick's cached source rows went stale at the move:
        # every source (the movers too) counted each of its 12 sends
        ra = eng.arena_for("RouteSource")
        srows = torch.from_numpy(ra.lookup_rows(sources)[0].astype(
            np.int64)).to(dev)
        require(bool((ra.state["sent"].index_select(0, srows) == 12).all()),
                f"migration arm (migrated={migrate}): a source's sends "
                f"were lost or doubled")
        if migrate:
            out["exchange"] = _ex_counts(eng)
        del eng, inj
        gc.collect()
        torch.cuda.empty_cache()
    for c in ("total", "received"):
        require(np.array_equal(states[True][c], states[False][c]),
                f"migration arm: {c} != the never-migrated engine's")
    return out


def drive_exchange_path(dev, card: str, timer) -> dict:
    """Phase 13: K23/K24 against their plain versions; the routing sweep
    over 8 shard blocks at bench.py ``_multichip_tier``'s full size
    (4,000,000 sources, 524,288 sinks, ratios 0.9, 0.5, 0.1, 0) in three
    arms — the structured exchange ("always", legacy layout), exchange off,
    and "auto" (disengaged on one card: identity plus the sampled probe) —
    unfused and fused; the throughput point (262,144 / 8,192, ratio 0.1,
    windows of 64); the per-destination, overflow and migration arms.
    Launch counts zeroed before each arm and read after it."""
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.samples import routing
    from orleans_tpu_torch.tensor.arena import shard_of_keys
    from orleans_tpu_torch.tensor.exchange import ladder_ceil

    out = {"counts": {}, "report": {}}
    out["kernels"] = check_exchange_kernels(dev, timer, card)
    gc.collect()
    torch.cuda.empty_cache()
    sources = np.arange(EX_SOURCES, dtype=np.int64)
    sinks = routing.sink_keys(EX_SINKS)
    values = np.random.default_rng(1).integers(1, 8, EX_SOURCES) \
        .astype(np.float32)   # run_routing_load's draw (seed 0 + 1)
    # the unfused source leg's chunks: the injector's lanes in key order
    lane_chunk = np.arange(EX_SOURCES) // ladder_ceil(-(-EX_SOURCES
                                                        // EX_BLOCKS))
    shared = dict(
        sources=sources, sinks=sinks, values=values,
        values_d=torch.from_numpy(values).to(dev),
        dst={r: routing.build_ratio_destinations(sources, sinks, EX_BLOCKS,
                                                 r, seed=0)
             for r in EX_RATIOS},
        src_cross=int((shard_of_keys(sources, EX_BLOCKS)
                       != lane_chunk).sum()))
    arms = {}
    for arm in ("always", "off", "auto"):
        for fused in (False, True):
            name = f"exchange_{arm}_{'fused' if fused else 'unfused'}"
            t0 = time.perf_counter()
            arms[name] = _ex_sweep_arm(dev, card, arm, fused, shared)
            arms[name]["arm_seconds"] = time.perf_counter() - t0
            out["counts"][name] = arms[name].pop("counts")
            out["report"][name] = arms[name].pop("report")
            print(f"sweep {name}: " + ", ".join(
                f"ratio {r}: {v['messages_per_sec']:.0f} messages/s"
                for r, v in arms[name]["ratios"].items())
                + f"; exact; {arms[name]['arm_seconds']:.1f} s; on {card}",
                flush=True)
    # the throughput point
    _build.reset_launch_counts()
    tp_n, tp_s, tp_r, tp_ticks, tp_w = EX_TP
    eng = _ex_engine(dev, exchange_structured="always")
    st = asyncio.run(routing.run_routing_load(eng, tp_n, tp_s, tp_r,
                                              n_ticks=tp_ticks,
                                              fused_window=tp_w))
    tp_src = np.arange(tp_n, dtype=np.int64)
    tp_sinks = routing.sink_keys(tp_s)
    tp_oracle = _SinkOracle(tp_src, tp_sinks, np.random.default_rng(1)
                            .integers(1, 8, tp_n).astype(np.float32))
    tp_oracle.add(routing.build_ratio_destinations(tp_src, tp_sinks,
                                                   EX_BLOCKS, tp_r),
                  st["total_ticks"])
    tp_oracle.check(eng, "throughput point")
    out["counts"]["exchange_throughput"] = _build.launch_counts()
    out["report"]["exchange_throughput"] = _build.launch_report()
    require(out["counts"]["exchange_throughput"]["exchange_buckets"] > 0,
            "throughput point: K24 never launched")
    arms["throughput"] = dict(messages_per_sec=st["messages_per_sec"],
                              seconds=st["seconds"],
                              total_ticks=st["total_ticks"],
                              bucket_utilization=st["bucket_utilization"])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    arms.update(_ex_extra_arms(dev, card, shared))
    out["counts"]["exchange_overflow"] = arms["overflow"].pop("counts")
    out["counts"]["exchange_per_dest"] = arms["per_dest"].pop("counts")
    _build.reset_launch_counts()
    arms["migration"] = _ex_migration_arm(dev, card, shared)
    out["counts"]["exchange_migration"] = _build.launch_counts()
    require(out["counts"]["exchange_migration"]["exchange_buckets"] > 0,
            "migration arm: K24 never launched")
    out["arms"] = arms
    tp, pd, ov, mg = (arms["throughput"], arms["per_dest"],
                      arms["overflow"], arms["migration"])
    a, f = arms["exchange_always_unfused"], arms["exchange_always_fused"]
    o, of = arms["exchange_off_unfused"], arms["exchange_off_fused"]
    a5, o5 = a["ratios"][0.5], o["ratios"][0.5]
    print(f"exchange at ratio 0.5, {EX_SOURCES} sources / {EX_SINKS} sinks "
          f"over {EX_BLOCKS} blocks: unfused tick "
          f"{a5['tick_device_ms']:.3f} ms on the device (off "
          f"{o5['tick_device_ms']:.3f}), "
          f"fused window of {EX_WINDOW} "
          f"{f['ratios'][0.5]['window_device_ms']:.3f} ms (off "
          f"{of['ratios'][0.5]['window_device_ms']:.3f}); throughput point "
          f"{tp['messages_per_sec']:.0f} messages/s; per-destination "
          f"{pd['messages_per_sec']:.0f} messages/s exact; overflow "
          f"{ov['dropped_msgs']} dropped, {ov['redeliveries']} "
          f"redeliveries, {ov['ledger_late_lanes']} late lanes in the "
          f"ledger, exact; migration {mg['moved']} grains in "
          f"{mg['move_s']:.3f} s ({mg['move_launches']}), exact against "
          f"the never-migrated engine; on {card}", flush=True)
    print("exchange arms: " + json.dumps(arms, default=str), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    from orleans_tpu_torch.device import card_report
    from orleans_tpu_torch.kernels import _build
    # every counted wrapper registered before the first path is counted,
    # so each path's report names every kernel
    from orleans_tpu_torch.kernels import exchange, router  # noqa: F401

    card = card_report()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} (torch: {kind}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})", flush=True)

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {len(built)} kernel libraries in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    dev = torch.device("cuda")
    timer = Timer(dev)
    wide = wide_inputs()
    graph = chirper_graph()
    results = check_kernels(dev, timer, card)
    results.update(check_attr_kernels(dev, timer, card))
    results.update(check_new_kernels(dev, timer, card, wide, graph))
    results.update(check_lifecycle_kernels(dev, timer, card))
    time_plain_programs(dev, timer, card)
    results["window_bound_ms"] += results["attr_window_bound_ms"]
    t1 = time.perf_counter()
    unfused_counts, runs = drive_unfused_path(dev, card)
    t2 = time.perf_counter()
    fused = drive_fused_path(dev, card, runs["tick_device_ms"],
                             results["window_bound_ms"])
    t3 = time.perf_counter()
    wide_out = drive_wide_path(dev, card, wide)
    t4 = time.perf_counter()
    chirper_out = drive_chirper_path(dev, card, graph)
    t5 = time.perf_counter()
    collection = drive_collection_path(dev, card)
    t6 = time.perf_counter()
    timers = drive_timers_path(dev, card)
    t7 = time.perf_counter()
    composed = drive_composition_path(dev, card)
    t8 = time.perf_counter()
    streams = drive_streams_path(dev, card, timer)
    results.update(streams["kernels"])
    t9 = time.perf_counter()
    results.update(check_replica_kernels(dev, timer, card))
    hot = drive_hot_grain_path(dev, card)
    t10 = time.perf_counter()
    gps = drive_gps_path(dev, card)
    twitter = drive_twitter_path(dev, card)
    t11 = time.perf_counter()
    durability = drive_durability_path(dev, card, timer)
    results.update(durability["kernels"])
    t12 = time.perf_counter()
    cluster = drive_cluster_path(dev, card, timer)
    results.update(cluster["kernels"])
    t13 = time.perf_counter()
    exchange_out = drive_exchange_path(dev, card, timer)
    results.update(exchange_out["kernels"])
    t14 = time.perf_counter()
    print(f"phase seconds: kernels {t1 - t0:.1f}, unfused {t2 - t1:.1f}, "
          f"fused {t3 - t2:.1f}, wide {t4 - t3:.1f}, chirper "
          f"{t5 - t4:.1f}, collection {t6 - t5:.1f}, timers {t7 - t6:.1f}, "
          f"composition {t8 - t7:.1f}, streams {t9 - t8:.1f}, hot grain "
          f"{t10 - t9:.1f}, gps and twitter {t11 - t10:.1f}, durability "
          f"{t12 - t11:.1f}, cluster {t13 - t12:.1f}, exchange "
          f"{t14 - t13:.1f}", flush=True)
    plane = runs["plane_ms"]
    fused_added = (fused["window_device_ms"]
                   - fused["window_off_device_ms"]) / 16
    print(f"attribution plane on the device: unfused "
          f"+{plane['proven'] - plane['off']:.4f} ms per tick with its folds "
          f"host-proven, +{plane['checked'] - plane['off']:.4f} with them "
          f"checked on the device ({plane['proven']:.4f}, "
          f"{plane['checked']:.4f} and {plane['off']:.4f} without it, per "
          f"tick over blocks of 16 ticks holding one flush); fused "
          f"+{fused_added:.4f} ms per fused tick ({fused['window_device_ms']:.4f} ms per "
          f"window with it, {fused['window_off_device_ms']:.4f} without); "
          f"the parked miss-check copies {runs['park_copy_ms']:.4f} ms per "
          f"unfused tick; on {card}", flush=True)

    # the windows' bounds beside Presence's: WidePresence (K10 for K1, one
    # K3 add), Chirper (200,000 publishers and the fan-out's lanes over the
    # accounts) and chat (4,096 rooms, the pull layout's edges over the
    # users); lanes and rows as the paths run them
    m, caps = PLAYERS, wide_out["caps"]
    cap_wg = caps["WideGame"]
    wide_bound = window_bound(
        [("resolve_wide", 16, results["resolve_wide"]["bound"][0]),
         ("row_scatter", 16, bound(m * 16)[0]),
         ("seg_sum", 32, bound(m * 8 + cap_wg * 4)[0]),
         ("hist_count", 16, bound(3 * (m + 4))[0])]
        + fold_bounds([(m, m), (m, WIDE_GAMES)],
                      [(caps["WidePresence"], m), (cap_wg, WIDE_GAMES)]),
        wide_out["fused"]["per_replay"], "wide")
    a, w, caps = ACCOUNTS, len(graph["dst"]), chirper_out["caps"]
    cap_a = caps["ChirperAccount"]
    chirper_bound = window_bound(
        [("fanout_expand", 16, results["fanout_expand"]["bound"][0]),
         ("resolve_dense", 16, bound(w * 9 + caps["dense"] * 4 + 4)[0]),
         ("seg_sum", 16, bound(a * 8 + cap_a * 4)[0]),
         ("seg_sum", 32, bound(w * 8 + cap_a * 4)[0]),
         ("row_scatter", 16, bound(w * 8 + cap_a * 4)[0]),
         ("hist_count", 16, bound(a + 2 * w + 12)[0])]
        + fold_bounds([(a, a), (w, a)], [(cap_a, a)]),
        chirper_out["fused"]["per_replay"], "chirper")
    r, caps = CHAT_ROOMS, streams["caps"]
    e, cap_r, cap_u = caps["edges"], caps["ChatRoomGrain"], \
        caps["ChatUserGrain"]
    chat_bound = window_bound(
        [("seg_sum", 16, bound(r * 8 + cap_r * 4)[0]),
         ("row_scatter", 16, bound(r * 8 + cap_r * 4)[0]),
         ("hist_count", 16, bound(r + 2 * e + 12)[0]),
         ("seg_pull", 48, bound(4 * e + 4 * (cap_u + 1) + 4 * cap_u)[0]),
         ("seg_pull", 16, bound(e + 4 * (cap_u + 1) + 8 * cap_u + 8)[0])]
        + fold_bounds([(r, r)], [(cap_r, r), (cap_u, CHAT_USERS)]),
        streams["fused"]["per_replay"], "chat")
    print(f"window bounds (sum of each launch's bytes bound, one window of "
          f"16): Presence {fused['window_bound_ms']:.4f} ms (device "
          f"{fused['window_device_ms']:.4f}), WidePresence "
          f"{wide_bound:.4f} ({wide_out['fused']['window_device_ms']:.4f})"
          f", Chirper {chirper_bound:.4f} "
          f"({chirper_out['fused']['window_device_ms']:.4f}), chat "
          f"{chat_bound:.4f} ({streams['fused']['window_device_ms']:.4f}); "
          f"on {card}", flush=True)

    # device launches per path (eager + graph replays), each path's counts
    # zeroed just before it and read just after
    paths = {"presence_unfused": unfused_counts,
             "presence_fused": fused["counts"],
             **wide_out["counts"], **chirper_out["counts"],
             "collection": collection["counts"], "timers": timers["counts"],
             "composition": composed["counts"], **streams["counts"]}
    # K18 launches only on arenas that hold replicas: every earlier path
    # must count none
    for path, c in paths.items():
        require(c.get("spread_replicas", 0) == 0,
                f"spread_replicas launched on the {path} path")
    # durability and cluster arms: no replica group anywhere either; K22
    # launches on the cluster arms only
    for path, c in {**durability["counts"], **cluster["counts"]}.items():
        require(c.get("spread_replicas", 0) == 0,
                f"spread_replicas launched on the {path} path")
    for path, c in {**paths, **hot["counts"], **gps["counts"],
                    **twitter["counts"], **durability["counts"]}.items():
        require(c.get("gather_args", 0) == 0,
                f"gather_args launched on the {path} path")
    # K23/K24 run over shard blocks only: every earlier path (one block)
    # counts none; the exchange arms launch no K18 and no K22
    for path, c in {**paths, **hot["counts"], **gps["counts"],
                    **twitter["counts"], **durability["counts"],
                    **cluster["counts"]}.items():
        for name in ("exchange_classify", "exchange_buckets"):
            require(c.get(name, 0) == 0, f"{name} launched on the {path} "
                    f"path")
    for path, c in exchange_out["counts"].items():
        for name in ("spread_replicas", "gather_args"):
            require(c.get(name, 0) == 0, f"{name} launched on the {path} "
                    f"path")
    paths.update({**hot["counts"], **gps["counts"], **twitter["counts"],
                  **durability["counts"], **cluster["counts"],
                  **exchange_out["counts"]})
    reports = {"presence_fused": fused["report"], **wide_out["report"],
               **chirper_out["report"], "collection": collection["report"],
               "timers": timers["report"], "composition": composed["report"],
               **streams["report"], **hot["report"], **gps["report"],
               **twitter["report"], **durability["report"],
               **cluster["report"], **exchange_out["report"]}
    per_replay = {"presence_fused": fused["per_replay"],
                  "wide_fused": wide_out["fused"]["per_replay"],
                  "chirper_fused": chirper_out["fused"]["per_replay"],
                  "chat_fused": streams["fused"]["per_replay"],
                  "hot_grain_fused": hot["fused"]["per_replay"]}
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": sum(c.get(name, 0) for c in paths.values()),
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                 "bound_by": r["bound"][1], "library_ms": r["library_ms"],
                 "library": r["library"], "host_ms": r["host_ms"],
                 "launches_by_path": {
                     **{p: c.get(name, 0) for p, c in paths.items()},
                     **{f"{p}_by_kind": by_kind[name]
                        for p, by_kind in reports.items()},
                     **{f"{p}_per_replay": pr.get(name, 0)
                        for p, pr in per_replay.items()}},
                 # every comparison above passed, or the run stopped there
                 "matches_plain": True}
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        if "library_note" in r:
            entry["library_note"] = r["library_note"]
        for key in ("per", "fill_ms", "kernel_ms", "path", "variants"):
            if key in r:
                entry[key] = r[key]
        kernels.append(entry)
    # numpy scalars (a variant's error or bound) print as floats
    print(json.dumps({"kernels": kernels}, default=float))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
