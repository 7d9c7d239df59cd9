"""K1 ``resolve_dense`` and K3 ``row_scatter`` taken apart on one CUDA
card.

``chip_smoke.py`` holds both kernels against their plain versions and
times them once.  This script reads them beside their library calls at
the shapes of the main path:

* K1 on Presence's game emit (1,000,000 lanes against the 16,384-entry
  dense map): the wrapper with its miss counter's zero fill, the kernel
  alone (into a given counter, as a fused window calls it), the fill
  alone, and ``torch.index_select``;
* K3 on each of the smoke's cases (Presence's SETs, heartbeats and
  touches, the float fan-ins onto GameGrain's rows, the routing sample's
  touch of its 256 sinks and of its hot sink, the routing sweep's touches
  and fan-in at 4,000,000 lanes), each with the path ``scatter_plan``
  chose, beside its library call;
* with ``--sweep`` (a tree with the tunables only): K1 at several grids;
  each K3 ADD and MAX case forced direct and privatized (clusters of 2 to
  16); and the crossing of the two paths, ADD, MAX and the touch at 1 to
  64 lanes a word on 32,768 words, which sets ``scatter_plan``'s
  thresholds.

Times: median over 25 runs, L2 flushed and the stream held by a spin
kernel before each (``chip_smoke.Timer``).  With ``--paths`` it first
drives the smoke's paths that run K1 and K3 and reads their device times
as the smoke does: the Presence fused window of 16 with the attribution
plane and without it (phase 5), Chirper's fused window of 16 (phase 7),
chat's fused window of 16 (phase 9), the routing sample's arms (phase 10,
each arm's device ms a tick) and, through ``trace_hot_grain.trace_arms``,
the uniform, hot-sink, k = 2 and k = 8 ticks kernel by kernel.  It runs
in the repository root:

    python3 probe_k1_k3.py [--paths] [--sweep]

It prints the card's name and power limit, then one JSON object.  The
script runs on any tree of the port with these wrappers (copy it and
``trace_hot_grain.py`` into an older tree), so two trees can be compared
in one call.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

GAME_ROWS, SINK_ROWS, SINKS = 1 << 15, 1024, 256
PLAYER_ROWS, DENSE = 1 << 21, 1 << 14
HOT_LANES = 1_048_576
EX_LANES, EX_SINKS = 4_000_000, 524_288
EX_SOURCE_ROWS, EX_SINK_ROWS = 1 << 23, 1 << 20
TICK = 7
# forced K3 privatized paths of the sweep: clusters of 2 to 16
SWEEP_CLUSTERS = (2, 4, 8, 16)
SWEEP_GRIDS = ((256, 2), (256, 4), (512, 2), (512, 4), (1024, 1), (1024, 2))


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def probe_resolve(dev, timer, sweep: bool) -> dict:
    from orleans_tpu_torch.kernels import resolve
    from orleans_tpu_torch.samples.presence import presence_inputs

    import chip_smoke as cs

    _, games, _ = presence_inputs(cs.PLAYERS, cs.GAMES, seed=0)
    games_d = _t(games, dev)
    valid_d = torch.ones(len(games), dtype=torch.bool, device=dev)
    dense = np.full(DENSE, -1, np.int32)
    dense[:cs.GAMES] = np.arange(cs.GAMES, dtype=np.int32)
    dense_d = _t(dense, dev)
    total = torch.zeros(1, dtype=torch.int32, device=dev)
    got = resolve.resolve_dense(dense_d, games_d, valid_d)
    want = resolve.resolve_dense_plain(dense_d, games_d, valid_d)
    if not (torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])):
        raise RuntimeError("resolve_dense != plain")
    out = {"ms": timer(lambda: resolve.resolve_dense(dense_d, games_d,
                                                     valid_d)),
           "kernel_ms": timer(lambda: resolve.resolve_dense(
               dense_d, games_d, valid_d, total)),
           "fill_ms": timer(lambda: torch.zeros((), dtype=torch.int32,
                                                device=dev)),
           "index_select_ms": timer(lambda: torch.index_select(
               dense_d, 0, games_d)),
           "bound_ms": cs.bound(len(games) * 9 + DENSE * 4 + 4)[0]}
    if sweep and hasattr(resolve, "DENSE_THREADS"):
        saved = (resolve.DENSE_THREADS, resolve.DENSE_BLOCKS_PER_SM)
        for threads, per_sm in SWEEP_GRIDS:
            resolve.DENSE_THREADS, resolve.DENSE_BLOCKS_PER_SM = \
                threads, per_sm
            out[f"t{threads}_sm{per_sm}_kernel_ms"] = timer(
                lambda: resolve.resolve_dense(dense_d, games_d, valid_d,
                                              total))
        resolve.DENSE_THREADS, resolve.DENSE_BLOCKS_PER_SM = saved
    return out


def k3_cases(dev) -> list:
    """(name, op, column factory, rows, values, library call on a column,
    bytes) at the smoke's shapes (``chip_smoke.check_kernels``)."""
    from orleans_tpu_torch.samples.presence import presence_inputs

    import chip_smoke as cs

    _, games, scores = presence_inputs(cs.PLAYERS, cs.GAMES, seed=0)
    m = cs.PLAYERS
    rng = np.random.default_rng(1234)
    games_d, scores_d = _t(games, dev), _t(scores, dev)
    prow_d = torch.arange(m, dtype=torch.int32, device=dev)
    prow64, games64 = prow_d.long(), games_d.long()
    ones_d = torch.ones(m, dtype=torch.int32, device=dev)
    fvals_d = _t(rng.standard_normal(m).astype(np.float32), dev)
    tick_0d = torch.tensor(TICK, dtype=torch.int32, device=dev)
    tick_m = torch.full((m,), TICK, dtype=torch.int32, device=dev)
    sink_rows_d = _t(np.random.default_rng(20260806).integers(
        0, SINKS, HOT_LANES).astype(np.int32), dev)
    hot_rows_d = torch.full((HOT_LANES,), 3, dtype=torch.int32, device=dev)
    sink64, hot64 = sink_rows_d.long(), hot_rows_d.long()
    tick_hot = torch.full((HOT_LANES,), TICK, dtype=torch.int32, device=dev)
    ex_src_d = torch.arange(EX_LANES, dtype=torch.int32, device=dev)
    ex_live = rng.choice(EX_SINK_ROWS, EX_SINKS, replace=False)
    ex_sink_d = _t(ex_live[rng.integers(0, EX_SINKS, EX_LANES)].astype(
        np.int32), dev)
    ex_src64, ex_sink64 = ex_src_d.long(), ex_sink_d.long()
    ex_vals_d = _t(rng.integers(1, 8, EX_LANES).astype(np.float32), dev)
    tick_ex = torch.full((EX_LANES,), TICK, dtype=torch.int32, device=dev)

    def zeros(n, dtype=torch.int32):
        return lambda: torch.zeros(n, dtype=dtype, device=dev)

    return [
        ("set i32 game", "set", lambda: torch.full(
            (PLAYER_ROWS,), -1, dtype=torch.int32, device=dev), prow_d,
         games_d, lambda c: c.index_put_((prow64,), games_d), m * 12),
        ("set i32 tick (scalar)", "set", zeros(PLAYER_ROWS), prow_d,
         np.int32(TICK), lambda c: c.index_put_((prow64,), tick_0d),
         m * 8),
        ("set i32 tick (device scalar)", "set", zeros(PLAYER_ROWS), prow_d,
         tick_0d, lambda c: c.index_put_((prow64,), tick_0d),
         m * 8 + 4),
        ("add i32 heartbeats", "add", zeros(PLAYER_ROWS), prow_d, ones_d,
         lambda c: c.index_add_(0, prow_d, ones_d), m * 16),
        ("max i32 touch players (scalar)", "max", zeros(PLAYER_ROWS), prow_d,
         TICK, lambda c: c.scatter_reduce_(0, prow64, tick_m,
                                           "amax"), m * 12),
        ("max i32 touch games (scalar)", "max", zeros(GAME_ROWS), games_d,
         TICK, lambda c: c.scatter_reduce_(0, games64, tick_m,
                                           "amax"), m * 4 + cs.GAMES * 8),
        ("add f32 fan-in", "add", zeros(GAME_ROWS, torch.float32), games_d,
         scores_d, lambda c: c.index_add_(0, games_d, scores_d),
         m * 8 + cs.GAMES * 8),
        ("max f32 fan-in", "max", zeros(GAME_ROWS, torch.float32), games_d,
         fvals_d, lambda c: c.scatter_reduce_(0, games64, fvals_d,
                                              "amax"), m * 8 + cs.GAMES * 8),
        ("max i32 touch sinks (scalar)", "max", zeros(SINK_ROWS),
         sink_rows_d, TICK, lambda c: c.scatter_reduce_(
             0, sink64, tick_hot, "amax"),
         HOT_LANES * 4 + SINKS * 8),
        ("max i32 touch hot sink (scalar)", "max", zeros(SINK_ROWS),
         hot_rows_d, TICK, lambda c: c.scatter_reduce_(
             0, hot64, tick_hot, "amax"), HOT_LANES * 4 + 8),
        # the routing sweep's tick (chip_smoke phase 13): 4,000,000 sources
        # touched in row order, and their lanes on 524,288 sinks spread at
        # random over the sink arena's 1,048,576 rows
        ("max i32 touch sweep sources (scalar)", "max",
         zeros(EX_SOURCE_ROWS), ex_src_d, TICK, lambda c: c.scatter_reduce_(
             0, ex_src64, tick_ex, "amax"), EX_LANES * 12),
        ("max i32 touch sweep sinks (scalar)", "max", zeros(EX_SINK_ROWS),
         ex_sink_d, TICK, lambda c: c.scatter_reduce_(
             0, ex_sink64, tick_ex, "amax"), EX_LANES * 4 + EX_SINKS * 8),
        ("add f32 sweep sinks", "add", zeros(EX_SINK_ROWS, torch.float32),
         ex_sink_d, ex_vals_d, lambda c: c.index_add_(0, ex_sink_d,
                                                      ex_vals_d),
         EX_LANES * 8 + EX_SINKS * 8),
    ]


def _scalar(values) -> bool:
    return not isinstance(values, torch.Tensor) or values.dim() == 0


def _forced(cluster, n):
    """K3's privatized path forced onto clusters of ``cluster``."""
    from orleans_tpu_torch.kernels import scatter, segment

    chunk = -(-n // cluster)
    return segment.SegPlan(cluster, -(-chunk // 4) * 4,
                           *scatter.SCATTER_PRIVATE)


def _same(a, b) -> bool:
    if a.dtype == torch.float32:
        return bool(torch.allclose(a, b, rtol=1e-5, atol=1e-2))
    return torch.equal(a, b)


def probe_row_scatter(dev, timer, sweep: bool) -> dict:
    import chip_smoke as cs
    from orleans_tpu_torch.kernels import scatter, segment

    out = {}
    planned = hasattr(scatter, "scatter_plan")
    for name, op, make, rows, values, library, nbytes in k3_cases(dev):
        col = make()
        if not _same(scatter.row_scatter(make(), rows, values, op),
                     scatter.row_scatter_plain(make(), rows, values, op)):
            raise RuntimeError(f"row_scatter != plain ({name})")
        row = {"ms": timer(lambda: scatter.row_scatter(col, rows, values,
                                                       op)),
               "library_ms": timer(lambda: library(col)),
               "bound_ms": cs.bound(nbytes)[0]}
        if planned:
            plan = scatter.scatter_plan(rows.shape[0], col.shape[0], 1, op,
                                        _scalar(values))
            row["plan"] = plan._asdict()
        if sweep and planned and op != "set":
            n = col.shape[0]
            forced = [("direct", segment.SegPlan(
                0, 0, *scatter.SCATTER_DIRECT))]
            if 4 * n <= 128 * 1024:
                forced += [(f"cluster{c}", _forced(c, n))
                           for c in SWEEP_CLUSTERS]
            for key, plan in forced:
                row[f"{key}_ms"] = timer(lambda: scatter.launch(
                    col, rows, values, op, plan))
        out[name] = row
    if sweep and planned:
        out["crossing"] = crossing(dev, timer)
    return out


def crossing(dev, timer) -> dict:
    """Direct against privatized (clusters of 8) at 1 to 64 lanes a word
    on 32,768 words, rows uniform at random: ADD and MAX of float32
    values and the int32 touch."""
    from orleans_tpu_torch.kernels import scatter, segment

    words = 1 << 15
    rng = np.random.default_rng(5)
    out = {}
    direct = segment.SegPlan(0, 0, *scatter.SCATTER_DIRECT)
    private = _forced(8, words)
    for per in (1, 2, 4, 8, 16, 32, 64):
        m = per * words
        rows = _t(rng.integers(0, words, m).astype(np.int32), dev)
        vals = _t(rng.standard_normal(m).astype(np.float32), dev)
        for what, op, dtype, values in (
                ("add f32", "add", torch.float32, vals),
                ("max f32", "max", torch.float32, vals),
                ("touch i32", "max", torch.int32, TICK)):
            col = torch.zeros(words, dtype=dtype, device=dev)
            for key, plan in (("direct", direct), ("private", private)):
                out[f"{what} {per} per word {key}_ms"] = timer(
                    lambda: scatter.launch(col, rows, values, op, plan))
    return out


def probe_paths(dev, card: str) -> dict:
    import chip_smoke as cs
    import trace_hot_grain

    fused = cs.drive_fused_path(dev, card, 0.0, 0.0)
    graph = cs.chirper_graph()
    chirper = cs.drive_chirper_path(dev, card, graph)
    streams = cs.drive_streams_path(dev, card, cs.Timer(dev))
    hot = cs.drive_hot_grain_path(dev, card)
    traced, _, _, _ = trace_hot_grain.trace_arms(dev, card)
    k3 = {}
    for r in traced:
        k3.setdefault(r["arm"], []).append(sum(
            v["ms_per_tick"] for key, v in r["kernels"].items()
            if "scatter" in key))
    return {"presence_window_device_ms": fused["window_device_ms"],
            "presence_window_off_device_ms": fused["window_off_device_ms"],
            "chirper_window_device_ms": chirper["fused"]["window_device_ms"],
            "chat_window_device_ms": streams["fused"]["window_device_ms"],
            "hot_grain_tick_device_ms": {
                name: a["tick_device_ms"] for name, a in hot["arms"].items()},
            "hot_grain_window_device_ms": hot["fused"]["window_device_ms"],
            "traced_tick_device_ms": {
                f"{r['arm']} round {r['round']}": r["tick_device_ms"]
                for r in traced},
            "traced_k3_ms_per_tick": k3,
            "traced": traced}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k1_k3: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from orleans_tpu_torch.device import card_report
    from orleans_tpu_torch.kernels import _build

    dev = torch.device("cuda")
    card = card_report()
    print(card, flush=True)
    _build.build_all()
    args = sys.argv[1:]
    result = {"card": card}
    if "--paths" in args:
        result["paths"] = probe_paths(dev, card)
    timer = cs.Timer(dev)
    result["resolve_dense"] = probe_resolve(dev, timer, "--sweep" in args)
    result["row_scatter"] = probe_row_scatter(dev, timer, "--sweep" in args)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
