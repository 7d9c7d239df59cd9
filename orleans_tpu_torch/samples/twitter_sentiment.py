"""TwitterSentiment sample — batched per-hashtag sentiment, on the port.

The torch twin of ``samples/twitter_sentiment.py`` (reference:
Samples/TwitterSentiment — TweetDispatcherGrain.cs:45 fans each tweet's
hashtags out as AddScore calls; HashtagGrain.cs AddScore :70 and the
first-activation counter :55; CounterGrain.cs IncrementCounter).  A
tick's tweets flatten into one (hashtag key, score) batch; hashtag rows
absorb the fan-in with sign-split segment sums, and the tick's first
activations reach the singleton counter as one message.

Two fan-in paths:

* ``add_score``, the scatter path: K4 sums per row and a K3 SET of
  ``last_score``.  With duplicate rows one writer wins, not a chosen one
  (``scatter_rows``; on the card any of them), so ``last_score`` is one
  of the scores the tag received in its last tick; the sums are exact.
* ``add_scores_grouped``, the pull path: the lanes arrive grouped by
  hashtag row with row-aligned ``segments`` (built on the host, outside
  the timed loop), so every sum is a K16 row reduction and
  ``last_score`` is each row's last lane, exactly.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from orleans_tpu_torch.core.grain import batched_method
from orleans_tpu_torch.hashing import jenkins_hash
from orleans_tpu_torch.tensor.vector_grain import (
    Batch,
    Emit,
    VectorGrain,
    field,
    scatter_rows,
    seg_sum,
    vector_grain,
)

COUNTER_KEY = 0  # singleton counter grain key (reference: GetGrain<ICounter>(0))


def hashtag_key(tag: str) -> int:
    """Map a hashtag string into the int31 device-routable key space."""
    return jenkins_hash(tag.lower().encode()) & 0x7FFFFFFE


def _counter_emit(newly: torch.Tensor) -> Emit:
    """The tick's first activations as ONE message to the counter (a fill
    and a sum, so a CUDA graph can capture it)."""
    return Emit(
        interface="TweetCounterGrain", method="increment",
        keys=torch.full((1,), COUNTER_KEY, dtype=torch.int32,
                        device=newly.device),
        args={"n": newly.to(torch.int32).sum(dtype=torch.int32)[None]})


@vector_grain
class HashtagGrain(VectorGrain):
    """Per-hashtag sentiment totals (reference: HashtagGrain.cs:49
    TotalsState — Positive/Negative/Total/BeenCounted)."""

    total = field(torch.int32, 0)
    positive = field(torch.int32, 0)
    negative = field(torch.int32, 0)
    counted = field(torch.int32, 0)         # 0 until first touch
    last_score = field(torch.int32, 0)

    @batched_method
    @staticmethod
    def add_score(state, batch: Batch, n_rows: int):
        rows, args, mask = batch.rows, batch.args, batch.mask
        score = args["score"].to(torch.int32)
        hits = seg_sum(mask.to(torch.int32), rows, n_rows)
        touched = hits > 0
        newly = touched & (state["counted"] == 0)
        state = {
            **state,
            "total": state["total"] + hits,
            "positive": state["positive"] + seg_sum(
                (mask & (score > 0)).to(torch.int32), rows, n_rows),
            "negative": state["negative"] + seg_sum(
                (mask & (score < 0)).to(torch.int32), rows, n_rows),
            "counted": touched.to(torch.int32) | state["counted"],
            "last_score": scatter_rows(state["last_score"], rows, score),
        }
        return state, None, (_counter_emit(newly),)

    @batched_method
    @staticmethod
    def add_scores_grouped(state, batch: Batch, n_rows: int):
        """The pull-mode fan-in: the tick's score lanes arrive grouped by
        destination row with row-aligned offsets in the args (``segments``,
        int32 ``[n_rows + 1]`` in arena-row order), so every sum is a K16
        row reduction and no lane scatters.  Contract: every lane valid,
        every destination row active."""
        args = batch.args
        seg = args["segments"].to(torch.int32)
        score = args["score"].to(torch.int32)
        deg = seg[1:] - seg[:-1]
        pos = seg_sum((score > 0).to(torch.int32), None, n_rows,
                      segments=seg)
        neg = seg_sum((score < 0).to(torch.int32), None, n_rows,
                      segments=seg)
        touched = deg > 0
        newly = touched & (state["counted"] == 0)
        # last_score: each row's LAST lane (the stable grouping keeps the
        # original order within a row)
        zscore = torch.cat([score, score.new_zeros(1)])
        last_new = zscore[torch.where(touched, seg[1:] - 1,
                                      score.shape[0]).long()]
        state = {
            **state,
            "total": state["total"] + deg,
            "positive": state["positive"] + pos,
            "negative": state["negative"] + neg,
            "counted": touched.to(torch.int32) | state["counted"],
            "last_score": torch.where(touched, last_new,
                                      state["last_score"]),
        }
        return state, None, (_counter_emit(newly),)


@vector_grain
class TweetDispatcherGrain(VectorGrain):
    """Batched dispatcher tier (reference: TweetDispatcherGrain.cs:45 — a
    ``[StatelessWorker]`` pool).  The pool is a fixed small row set and
    the tick's tweet slab rides as args, which makes the whole tick
    fusable: fixed source keys, per-tick (hashtag key, score) leaves, an
    emit whose destinations come from the args."""

    dispatched = field(torch.int32, 0)      # ticks this pool slot served

    @batched_method
    @staticmethod
    def dispatch(state, batch: Batch, n_rows: int):
        rows, args = batch.rows, batch.args
        state = {
            **state,
            "dispatched": state["dispatched"]
            + seg_sum(batch.mask.to(torch.int32), rows, n_rows),
        }
        emit = Emit(
            interface="HashtagGrain", method="add_score",
            keys=args["keys"].to(torch.int32),
            args={"score": args["score"].to(torch.int32)})
        return state, None, (emit,)

    @batched_method
    @staticmethod
    def dispatch_grouped(state, batch: Batch, n_rows: int):
        """The grouped firehose edge: the tick's slab arrives grouped by
        hashtag row (``score`` and row-aligned ``segments``), the
        destination key set is the static tag table (``tag_keys``), and
        ``HashtagGrain.add_scores_grouped`` applies the fan-in."""
        rows, args = batch.rows, batch.args
        state = {
            **state,
            "dispatched": state["dispatched"]
            + seg_sum(batch.mask.to(torch.int32), rows, n_rows),
        }
        emit = Emit(
            interface="HashtagGrain", method="add_scores_grouped",
            keys=args["tag_keys"].to(torch.int32),
            args={"score": args["score"].to(torch.int32),
                  "segments": args["segments"].to(torch.int32)})
        return state, None, (emit,)


@vector_grain
class TweetCounterGrain(VectorGrain):
    """Singleton activation counter (reference: CounterGrain.cs:46)."""

    hashtags = field(torch.int32, 0)

    @batched_method
    @staticmethod
    def increment(state, batch: Batch, n_rows: int):
        n = torch.where(batch.mask, batch.args["n"].to(torch.int32), 0)
        return {
            **state,
            "hashtags": state["hashtags"] + seg_sum(n, batch.rows, n_rows),
        }


def flatten_tweets(tweets: Sequence[Dict]) -> Dict[str, np.ndarray]:
    """Dispatcher tier (reference: TweetDispatcherGrain.AddScore :45):
    flatten a batch of tweets into one (hashtag key, score) batch."""
    keys: List[int] = []
    scores: List[int] = []
    for tw in tweets:
        for tag in tw["hashtags"]:
            keys.append(hashtag_key(tag))
            scores.append(int(tw["score"]))
    return {"keys": np.asarray(keys, dtype=np.int64),
            "scores": np.asarray(scores, dtype=np.int32)}


def _zipf_payloads(n_hashtags: int, m: int, n_ticks: int, zipf_a: float,
                   seed: int):
    """(tag_keys, [(keys, scores)] per tick): hashtag popularity ~ Zipf,
    scores in {-1, 0, +1}; the JAX loaders' draws, shared by every loader
    here so their runs compare tick for tick."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_hashtags + 1, dtype=np.float64)
    weights = ranks ** (-zipf_a)
    weights /= weights.sum()
    tag_keys = (np.arange(n_hashtags, dtype=np.int64) * 2654435761) \
        % 0x7FFFFFFE
    payloads = []
    for _ in range(n_ticks):
        tag_idx = rng.choice(n_hashtags, size=m, p=weights)
        payloads.append((tag_keys[tag_idx],
                         rng.integers(-1, 2, size=m).astype(np.int32)))
    return tag_keys, payloads


def _stats(n_tweets_per_tick: int, m: int, n_hashtags: int, n_ticks: int,
           elapsed: float, tick_durations: list, **extra) -> Dict:
    # per reference accounting: one AddScore per (tweet, hashtag) + one
    # dispatcher RPC per tweet
    messages = (m + n_tweets_per_tick) * n_ticks
    stats: Dict[str, float] = {
        "tweets": n_tweets_per_tick * n_ticks,
        "hashtags": n_hashtags,
        "ticks": n_ticks,
        "seconds": elapsed,
        "messages": messages,
        "messages_per_sec": messages / elapsed,
        **extra,
    }
    if tick_durations:
        d = np.asarray(tick_durations)
        stats["tick_p50_seconds"] = float(np.percentile(d, 50))
        stats["tick_p99_seconds"] = float(np.percentile(d, 99))
        stats["tick_max_seconds"] = float(d.max())
    return stats


async def run_twitter_load(engine, n_tweets_per_tick: int = 50_000,
                           n_hashtags: int = 5_000, tags_per_tweet: int = 2,
                           n_ticks: int = 10, zipf_a: float = 1.4,
                           seed: int = 0, warm_ticks: int = 0,
                           measure_latency: bool = False) -> Dict[str, float]:
    """The synthetic firehose, unfused: each tick's (hashtag key, score)
    slab goes in as one host-key batch to ``add_score``.  Payloads are
    made before the timed loop.  ``measure_latency=True`` waits for every
    tick's completion: the durations are inject→completion latencies."""
    m = n_tweets_per_tick * tags_per_tweet
    total = warm_ticks + n_ticks
    _tag_keys, payloads = _zipf_payloads(n_hashtags, m, total, zipf_a, seed)

    engine.arena_for("HashtagGrain").reserve(n_hashtags)
    engine.arena_for("TweetCounterGrain").reserve(1)

    for t in range(warm_ticks):  # activation, untimed
        keys, scores = payloads[t]
        engine.send_batch("HashtagGrain", "add_score", keys,
                          {"score": scores})
        await engine.drain_queues()
    await engine.flush()
    engine.wait_completion()

    tick_durations = []
    t0 = time.perf_counter()
    for t in range(warm_ticks, total):
        tick_t0 = time.perf_counter()
        keys, scores = payloads[t]
        engine.send_batch("HashtagGrain", "add_score", keys,
                          {"score": scores})
        if measure_latency:
            await engine.flush()
            engine.wait_completion()
            tick_durations.append(time.perf_counter() - tick_t0)
        else:
            await engine.drain_queues()
    await engine.flush()
    engine.wait_completion()
    elapsed = time.perf_counter() - t0
    return _stats(n_tweets_per_tick, m, n_hashtags, n_ticks, elapsed,
                  tick_durations)


async def _run_windows(engine, prog, windows: list, statics,
                       measure_latency: bool) -> tuple:
    """One untimed warm window on ``windows[0]``, rolled back (the state
    columns of every arena the window touches restored from copies, and
    the tick and message counters), then every window timed.  Returns
    (seconds, per-window durations)."""
    prog.prepare(windows[0], statics)
    snap = {n: {k: v.clone() for k, v in engine.arena_for(n).state.items()}
            for n in prog._touched}
    counters0 = (engine.tick_number, engine.messages_processed)
    prog.run(windows[0], static_args=statics)
    engine.wait_completion()
    misses = prog.verify()
    if misses:  # not assert: -O must not skip the exactness check
        raise RuntimeError(f"twitter warm window missed {misses}")
    for n, cols in snap.items():
        engine.arena_for(n).state = cols
    engine.tick_number, engine.messages_processed = counters0

    tick_durations = []
    t0 = time.perf_counter()
    for stacked in windows:
        w0 = time.perf_counter()
        prog.run(stacked, static_args=statics)
        if measure_latency:
            engine.wait_completion()
            tick_durations.append(time.perf_counter() - w0)
    engine.wait_completion()
    elapsed = time.perf_counter() - t0
    misses = prog.verify()
    if misses:
        raise RuntimeError(f"twitter window missed {misses}")
    return elapsed, tick_durations


def _prepare_pool(engine, n_dispatchers: int, n_hashtags: int,
                  tag_keys: np.ndarray) -> np.ndarray:
    """Reserve the three arenas and activate every destination (the steady
    state a window needs); returns the hashtag rows of ``tag_keys``."""
    engine.arena_for("TweetDispatcherGrain").reserve(n_dispatchers)
    engine.arena_for("HashtagGrain").reserve(n_hashtags)
    engine.arena_for("TweetCounterGrain").reserve(1)
    rows = engine.arena_for("HashtagGrain").resolve_rows(tag_keys)
    engine.arena_for("TweetCounterGrain").resolve_rows(
        np.asarray([COUNTER_KEY], dtype=np.int64))
    return rows


async def run_twitter_load_grouped(engine, n_tweets_per_tick: int = 50_000,
                                   n_hashtags: int = 5_000,
                                   tags_per_tweet: int = 2,
                                   n_ticks: int = 10, window: int = 10,
                                   zipf_a: float = 1.4, seed: int = 0,
                                   n_dispatchers: int = 64,
                                   measure_latency: bool = False
                                   ) -> Dict[str, float]:
    """The firehose through the grouped pull-mode path, fused: the same
    Zipf payloads as the other loaders, each tick's lanes stable-sorted by
    hashtag row with row-aligned offsets on the host before the timed
    loop, so the window's fan-in runs with K16 and no scatter.  Needs a
    fresh hashtag arena (rows in sorted-key order, which the offsets
    assume)."""
    from orleans_tpu_torch.tensor.fused import plan_windows

    m = n_tweets_per_tick * tags_per_tweet
    if measure_latency:
        window = 1
    window, n_windows, n_ticks = plan_windows(window, n_ticks)
    tag_keys, payloads = _zipf_payloads(n_hashtags, m, n_windows * window,
                                        zipf_a, seed)
    rows = _prepare_pool(engine, n_dispatchers, n_hashtags, tag_keys)
    arena = engine.arena_for("HashtagGrain")
    # activation sorts unseen keys, so a fresh one-block arena lays the
    # tag table out in sorted-key row order
    sorted_keys = np.sort(tag_keys)
    if not np.array_equal(rows, np.searchsorted(sorted_keys, tag_keys)):
        raise RuntimeError(
            "grouped twitter loader needs a fresh hashtag arena (rows "
            "must be allocation-ordered so the offsets are row-aligned)")
    cap = arena.capacity  # offsets are row-aligned: [capacity + 1]

    def group(keys, scores):
        rank = np.searchsorted(sorted_keys, keys)
        order = np.argsort(rank, kind="stable")
        seg = np.zeros(cap + 1, np.int32)
        seg[1:n_hashtags + 1] = np.cumsum(
            np.bincount(rank, minlength=n_hashtags))
        seg[n_hashtags + 1:] = seg[n_hashtags]  # rows past the table: empty
        return scores[order].astype(np.int32), seg

    dev = engine.device
    windows = []
    for w in range(n_windows):
        grouped = [group(k, s)
                   for k, s in payloads[w * window:(w + 1) * window]]
        windows.append({
            "score": torch.from_numpy(np.stack([g[0] for g in grouped]))
            .to(dev),
            "segments": torch.from_numpy(np.stack([g[1] for g in grouped]))
            .to(dev)})
    statics = {"tag_keys": torch.from_numpy(tag_keys.astype(np.int32))
               .to(dev)}
    pool = np.arange(n_dispatchers, dtype=np.int64)
    prog = engine.fuse_ticks("TweetDispatcherGrain", "dispatch_grouped",
                             pool)
    elapsed, durations = await _run_windows(engine, prog, windows, statics,
                                            measure_latency)
    return _stats(n_tweets_per_tick, m, n_hashtags, n_ticks, elapsed,
                  durations, engine="fused+grouped (pull-mode fan-in)")


async def run_twitter_load_fused(engine, n_tweets_per_tick: int = 50_000,
                                 n_hashtags: int = 5_000,
                                 tags_per_tweet: int = 2,
                                 n_ticks: int = 10, window: int = 10,
                                 zipf_a: float = 1.4, seed: int = 0,
                                 n_dispatchers: int = 64,
                                 measure_latency: bool = False
                                 ) -> Dict[str, float]:
    """The firehose through a fused program: the dispatcher pool's key set
    is fixed, each tick's (hashtag key, score) slab rides as ``[T, m]``
    leaves, and the chain — dispatcher emit, in-window resolve of the
    hashtag keys, the sign-split fan-in, the counter increment — runs as
    one program per window (on the card one CUDA graph replay).  Every
    hashtag is activated first; the warm window is rolled back, so the
    timed run starts from the state an unfused run of the same payloads
    starts from."""
    from orleans_tpu_torch.tensor.fused import plan_windows

    m = n_tweets_per_tick * tags_per_tweet
    if measure_latency:
        window = 1
    window, n_windows, n_ticks = plan_windows(window, n_ticks)
    tag_keys, payloads = _zipf_payloads(n_hashtags, m, n_windows * window,
                                        zipf_a, seed)
    _prepare_pool(engine, n_dispatchers, n_hashtags, tag_keys)
    dev = engine.device
    windows = []
    for w in range(n_windows):
        ticks = payloads[w * window:(w + 1) * window]
        windows.append({
            "keys": torch.from_numpy(np.stack(
                [k.astype(np.int32) for k, _ in ticks])).to(dev),
            "score": torch.from_numpy(np.stack([s for _, s in ticks]))
            .to(dev)})
    pool = np.arange(n_dispatchers, dtype=np.int64)
    prog = engine.fuse_ticks("TweetDispatcherGrain", "dispatch", pool)
    elapsed, durations = await _run_windows(engine, prog, windows, None,
                                            measure_latency)
    return _stats(n_tweets_per_tick, m, n_hashtags, n_ticks, elapsed,
                  durations, engine="fused")
