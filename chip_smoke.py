#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: the Presence tick on one NVIDIA card.

Run from the repository root on a machine with an H100 and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which fails loudly (exit code other than 0):

1. The card: ``nvidia-smi``'s name and power limit.  No card, no run.
2. Build: every kernel source in ``orleans_tpu_torch/csrc`` with ``nvcc``
   for ``sm_90a``, one compiler per source, all started together.
3. Kernels against their plain PyTorch versions on the card, at the
   shapes of Presence with 1,000,000 players and 10,000 games, on the
   main path's inputs and on adversarial inputs (padding rows -1, rows
   past the end, sentinel, negative, out-of-range and unseen keys).
   Integers must match exactly; float32 sums within Higham's bound for
   recursive summation (see ``_fan_in_tol``).  Each kernel is timed (median
   of CUDA-event times over 25 launches, L2 flushed before each) beside
   its plain version, one PyTorch library call as a yardstick, and its
   bound: the larger of the bytes it must move over 3.35 TB/s and its
   operations over the card's peak rate.
4. The main path: ``run_presence_load`` on ``TensorEngine(device="cuda")``
   at 1M players / 10k games, a pipelined run and a ``measure_latency``
   run, each checked exactly against a numpy oracle of the seeded load.
   Launch counters are zeroed just before and read just after; every
   kernel must have launched.
5. One JSON line of the kernels, the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import json
import math
import sys
import time

import numpy as np
import torch

PLAYERS, GAMES = 1_000_000, 10_000
WARM_TICKS, TICKS = 3, 20
REPS = 25
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT32_OPS_PER_S = 33.5e12      # integer ALU: half the 67 TFLOP/s float32 rate
SENTINEL = 2**31 - 1

SOURCES = {
    "resolve_dense": ("orleans_tpu_torch/csrc/resolve.cu",
                      "orleans_tpu/tensor/engine.py:233"),
    "resolve_sorted": ("orleans_tpu_torch/csrc/resolve.cu",
                       "orleans_tpu/tensor/engine.py:218"),
    "row_scatter": ("orleans_tpu_torch/csrc/scatter.cu",
                    "orleans_tpu/tensor/vector_grain.py:238"),
    "seg_sum": ("orleans_tpu_torch/csrc/segment.cu",
                "orleans_tpu/tensor/vector_grain.py:164"),
}
ALSO_REPLACES = {"row_scatter": ["orleans_tpu/tensor/vector_grain.py:253",
                                 "orleans_tpu/tensor/arena.py:34"]}


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

    def __call__(self, fn, reps: int = REPS) -> float:
        fn()  # warm: first launch loads the module
        torch.cuda.synchronize()
        times, host = [], []
        for _ in range(reps):
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


def measure(timer, kernel, plain, library) -> dict:
    """Device times of the kernel's wrapper, its plain version and the
    library yardstick, plus the host time the wrapper takes to enqueue."""
    ms = timer(kernel)
    host_ms = timer.host_ms
    return dict(ms=ms, host_ms=host_ms, plain_ms=timer(plain),
                library_ms=timer(library))


def bound(bytes_moved: float, int_ops: float = 0.0):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(dev, timer, card: str):
    from orleans_tpu_torch.kernels import resolve, scatter, segment
    from orleans_tpu_torch.samples.presence import presence_inputs

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
    steps = math.ceil(math.log2(cap_g + 1))
    results["resolve_sorted"] = dict(
        max_abs_err=0,
        library="torch.searchsorted (search only)",
        bound=bound(m * (4 + 1 + 4) + 2 * cap_g * 4 + 4,
                    int_ops=m * steps * 2),
        **measure(timer,
                  lambda: resolve.resolve_sorted(skeys_d, srows_d, games_d,
                                                 valid_d),
                  lambda: resolve.resolve_sorted_plain(skeys_d, srows_d,
                                                       games_d, valid_d),
                  lambda: torch.searchsorted(skeys_d, games_d)))

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
    # (name, op, column factory, rows, values, library call,
    #  bytes, on the steady tick's path)
    cases = [
        ("set i32 game", "set", lambda: torch.full((cap_p,), -1,
         dtype=torch.int32, device=dev), prow_d, games_d,
         lambda c: c.index_put_((prow64_d,), games_d), m * 12, True),
        ("set i32 tick (scalar)", "set", lambda: torch.zeros(
         cap_p, dtype=torch.int32, device=dev), prow_d, np.int32(tick),
         lambda c: c.index_put_((prow64_d,), tick_0d), m * 8, True),
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
        if isinstance(values, torch.Tensor):
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
                lane_vals = lanes.cpu().numpy()
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
        variants.append(dict(name=name, on_steady_tick=on_path,
                             max_abs_err=err, **times))
        if on_path:
            for key in totals:
                totals[key] += times[key]
    results["row_scatter"] = dict(
        max_abs_err=max_err, ms=totals["ms"], host_ms=totals["host_ms"],
        plain_ms=totals["plain_ms"], library_ms=totals["library_ms"],
        library="index_put_ / index_add_ / scatter_reduce_",
        bound=(totals["bound_ms"], "bytes"),
        per="sum of the 5 launches of one steady tick", variants=variants)

    # -- K4 seg_sum: the game fan-in -----------------------------------------
    seg_ms = dict(ms=0.0, host_ms=0.0, plain_ms=0.0, library_ms=0.0)
    seg_bound = 0.0
    seg_err = 0.0
    adv_rows_d = t(adversarial_rows(cap_g, unique=False))
    for vals_d in (scores_d, ones_d):
        for rows_d in (grow_d, adv_rows_d):
            a = segment.seg_sum(vals_d, rows_d, cap_g)
            b = segment.seg_sum_plain(vals_d, rows_d, cap_g)
            if vals_d.dtype == torch.int32:
                require(torch.equal(a, b), "seg_sum i32 != plain")
            else:
                diff = (a - b).abs().cpu().numpy()
                tol = _fan_in_tol(vals_d.cpu().numpy(), rows_d.cpu().numpy(),
                                  cap_g)
                require(bool(np.all(diff <= tol)),
                        "seg_sum f32 beyond tolerance")
                seg_err = max(seg_err, float(diff.max()))
        out = torch.zeros(cap_g, dtype=vals_d.dtype, device=dev)
        times = measure(
            timer, lambda: segment.seg_sum(vals_d, grow_d, cap_g),
            lambda: segment.seg_sum_plain(vals_d, grow_d, cap_g),
            lambda: out.index_add_(0, grow_d, vals_d))
        for key in seg_ms:
            seg_ms[key] += times[key]
        seg_bound += bound(m * 8 + cap_g * 4)[0]
    results["seg_sum"] = dict(
        max_abs_err=seg_err, library="index_add_",
        bound=(seg_bound, "bytes"), **seg_ms,
        per="sum of the 2 launches of one steady tick")

    for name, r in results.items():
        print(f"kernel {name}: {r['ms']:.4f} ms on the device, "
              f"{r['host_ms']:.4f} ms host enqueue "
              f"(plain {r['plain_ms']:.4f}, "
              f"library {r['library_ms']:.4f} [{r['library']}], bound "
              f"{r['bound'][0]:.4f} by {r['bound'][1]}) max_abs_err "
              f"{r['max_abs_err']:.3g} on {card}", flush=True)
        for v in r.get("variants", []):
            print(f"  {name} {v['name']}: {v['ms']:.4f} ms, host "
                  f"{v['host_ms']:.4f} (plain "
                  f"{v['plain_ms']:.4f}, library {v['library_ms']:.4f}, "
                  f"bound {v['bound_ms']:.4f})", flush=True)
    return results


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def check_presence(engine, stats, games, scores, warm, ticks) -> None:
    """Every column of both arenas against the numpy oracle of the load."""
    n_ticks = warm + ticks
    players = np.arange(PLAYERS, dtype=np.int64)
    require(stats["messages"] == 2 * PLAYERS * ticks, "stats messages")
    # every game-emit batch before the first miss-check drain (the warm
    # phase's flush) misses all its lanes and is delivered again
    want_msgs = 2 * PLAYERS * n_ticks + PLAYERS * warm
    require(engine.messages_processed == want_msgs,
            f"messages_processed {engine.messages_processed} != {want_msgs}")

    pa = engine.arena_for("PresenceGrain")
    rows, found = pa.lookup_rows(players)
    require(bool(found.all()) and pa.live_count == PLAYERS, "players live")
    cols = {k: v.cpu().numpy()[rows] for k, v in pa.state.items()}
    require(bool(np.all(cols["heartbeats"] == n_ticks)), "heartbeats")
    require(bool(np.all(cols["last_heartbeat"] == ticks)), "last_heartbeat")
    require(bool(np.array_equal(cols["game"], games)), "game")

    ga = engine.arena_for("GameGrain")
    game_keys = np.arange(GAMES, dtype=np.int64)
    present = np.bincount(games, minlength=GAMES) > 0
    rows, found = ga.lookup_rows(game_keys)
    require(np.array_equal(found, present)
            and ga.live_count == int(present.sum()), "games live")
    rows = rows[present]
    per_game = np.bincount(games, minlength=GAMES)[present]
    updates = ga.state["updates"].cpu().numpy()[rows]
    require(bool(np.array_equal(updates, per_game * n_ticks)), "updates")
    total = ga.state["total_score"].cpu().numpy()[rows].astype(np.float64)
    oracle = n_ticks * np.bincount(games, weights=scores.astype(np.float64),
                                   minlength=GAMES)[present]
    # float32 sums of k = updates positive terms in any order: Higham,
    # |err| <= (k - 1) * 2**-24 * sum|x| (+ O(2**-48)); k * 2**-24 covers it
    tol = updates * 2.0**-24 * oracle
    err = np.abs(total - oracle)
    require(bool(np.all(np.isfinite(total)) and np.all(err <= tol)),
            f"total_score off by {err.max()} (tolerance {tol.min()}..)")


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


def drive_main_path(dev, card: str):
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.samples.presence import (
        presence_inputs,
        run_presence_load,
    )
    from orleans_tpu_torch.tensor.engine import TensorEngine

    _, games, scores = presence_inputs(PLAYERS, GAMES, seed=0)
    _build.reset_launch_counts()
    runs = {}
    for mode in ("pipelined", "latency"):
        engine = TensorEngine(device=dev)
        stats = asyncio.run(run_presence_load(
            engine, n_players=PLAYERS, n_games=GAMES, n_ticks=TICKS, seed=0,
            measure_latency=(mode == "latency"), warm_ticks=WARM_TICKS))
        check_presence(engine, stats, games, scores, WARM_TICKS, TICKS)
        runs[mode] = stats
    counts = _build.launch_counts()
    print(f"launches on the main path: {json.dumps(counts)}", flush=True)
    for name in SOURCES:
        require(counts.get(name, 0) > 0,
                f"{name} never launched on the main path")
    runs["tick_device_ms"], runs["tick_host_ms"] = tick_device_ms(
        engine, torch.from_numpy(games).to(dev),
        torch.from_numpy(scores).to(dev))
    lat = runs["latency"]
    print(f"presence {PLAYERS} players / {GAMES} games, {TICKS} ticks after "
          f"{WARM_TICKS} warm: {runs['pipelined']['messages_per_sec']:.1f} "
          f"messages/s pipelined; tick p50 "
          f"{lat['tick_p50_seconds'] * 1e3:.3f} ms, p99 "
          f"{lat['tick_p99_seconds'] * 1e3:.3f} ms synced; one steady tick "
          f"{runs['tick_device_ms']:.4f} ms on the device, "
          f"{runs['tick_host_ms']:.4f} ms to enqueue on the host; on {card}",
          flush=True)
    return counts, runs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    from orleans_tpu_torch.device import card_report
    from orleans_tpu_torch.kernels import _build

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
    results = check_kernels(dev, timer, card)
    counts, _ = drive_main_path(dev, card)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": counts[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                 "bound_by": r["bound"][1], "library_ms": r["library_ms"],
                 "library": r["library"], "host_ms": r["host_ms"],
                 # every comparison above passed, or the run stopped there
                 "matches_plain": True}
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        if "per" in r:
            entry["per"] = r["per"]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
