"""K4 ``seg_sum`` and K8 ``attr_apply`` taken apart on one CUDA card.

``chip_smoke.py`` holds both kernels against their plain versions and
times them once.  This script reads them beside their library calls at
the shapes of the main path:

* K4, each with the path ``seg_plan`` chose, its time with the wrapper's
  zero fill and without it, the fill alone, and ``index_add_`` into a
  tensor allocated beforehand: Presence's pair (float32 scores and int32
  ones of 1,000,000 players on GameGrain's 32,768 rows); the routing
  sample's 256 sinks (1,048,576 lanes on the sink arena's 1,024 rows) with
  the output placed at every 512 B step of 16 KiB, as
  ``trace_hot_grain.py`` does; its hot sink (every lane on one row); and
  Chirper's fan-in (2,011,069 follower lanes on 262,144 account rows) at
  two output addresses, 1 KiB-aligned and 512 B past that;
* K8 beside ``add_(alpha=k)`` on the counts: the PresenceGrain flush of
  16 (2,097,152 rows and a 4x8192 sketch, k on the host) and the GameGrain
  flush (32,768 rows, k read on the device);
* with ``--sweep`` (a tree with the tunables only): each K4 shape forced
  onto each path (direct, every block flushing alone, clusters of 2 to 16)
  at several grids, and K8 at several blocks per SM, all in this call.

Times: median over 25 runs, L2 flushed and the stream held by a spin
kernel before each (``chip_smoke.Timer``).  With ``--paths`` it first
drives the smoke's paths that run K4 or K8 and reads their device times
as the smoke does: the Presence fused window of 16 with the attribution
plane and without it (phase 5), Chirper's fused window of 16 (phase 7),
the hot-grain arms (phase 10, each arm's device ms a tick) and the 2-silo
cross-silo Presence's device ms a tick per silo (phase 12, traced).  It
runs in the repository root:

    python3 probe_k4_k8.py [--paths] [--sweep]

It prints the card's name and power limit, then one JSON object.  The
script runs on any tree of the port with these wrappers, so two trees can
be compared in one call.
"""

from __future__ import annotations

import asyncio
import json
import sys

import numpy as np
import torch

GAME_ROWS, SINK_ROWS, SINKS, ACCOUNT_ROWS = 1 << 15, 1024, 256, 1 << 18
HOT_LANES = 1_048_576
# forced K4 paths of the sweep: (cluster, threads, blocks per SM)
SWEEP = [(0, 256, 8), (0, 256, 32), (0, 256, 64), (0, 512, 16),
         (1, 512, 2), (2, 512, 2), (4, 512, 2), (8, 512, 2), (8, 1024, 1),
         (16, 1024, 1)]


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _plan(segment, m, n_rows, dtype):
    """``seg_plan``'s choice, or None on a tree without it."""
    if not hasattr(segment, "seg_plan"):
        return None
    return segment.seg_plan(m, n_rows, 1, dtype)


def _into(segment, values, rows, out, plan):
    """K4 into ``out`` (zeroed by the caller) along ``plan``; a tree
    without ``launch`` takes its one path through the library."""
    if hasattr(segment, "launch"):
        segment.launch(values, rows, out, plan)
        return
    from orleans_tpu_torch.kernels import _build

    name = "seg_sum_f32" if values.dtype == torch.float32 else "seg_sum_i32"
    lib = _build.library("segment", segment._SIGNATURES)
    _build.check(lib, getattr(lib, name)(
        values.data_ptr(), rows.data_ptr(), rows.shape[0], 1,
        out.data_ptr(), out.shape[0],
        torch.cuda.current_stream().cuda_stream), name)


def k4_cases(dev, graph) -> list:
    """(name, values, rows, n_rows) at the smoke's shapes."""
    from orleans_tpu_torch.samples.presence import presence_inputs

    import chip_smoke as cs

    _, games, scores = presence_inputs(cs.PLAYERS, cs.GAMES, seed=0)
    rng = np.random.default_rng(20260806)
    sink_rows = rng.integers(0, SINKS, HOT_LANES).astype(np.int32)
    sink_vals = rng.integers(1, 8, HOT_LANES).astype(np.float32)
    dst = graph["dst"].astype(np.int32)
    return [
        ("presence scores (float32)", _t(scores, dev), _t(games, dev),
         GAME_ROWS),
        ("presence ones (int32)",
         torch.ones(len(games), dtype=torch.int32, device=dev),
         _t(games, dev), GAME_ROWS),
        ("256 sinks (float32)", _t(sink_vals, dev), _t(sink_rows, dev),
         SINK_ROWS),
        ("one hot sink (float32)", _t(sink_vals, dev),
         torch.zeros(HOT_LANES, dtype=torch.int32, device=dev), SINK_ROWS),
        ("chirper followers (int32)",
         torch.ones(len(dst), dtype=torch.int32, device=dev), _t(dst, dev),
         ACCOUNT_ROWS),
        # one silo's half of the cluster's game fan-in; collection's 500,000
        # players on 5,000 games; GPSTracker's 200,000 devices on 8
        # notifiers (each arena at its reserved capacity)
        ("cluster silo ones (int32)",
         torch.ones(len(games) // 2, dtype=torch.int32, device=dev),
         _t(games[::2], dev), GAME_ROWS),
        ("collection ones (int32)",
         torch.ones(500_000, dtype=torch.int32, device=dev),
         _t((np.arange(500_000) % 5_000).astype(np.int32), dev), 1 << 14),
        ("gps notifiers (int32)",
         torch.ones(200_000, dtype=torch.int32, device=dev),
         _t((np.arange(200_000) % 8).astype(np.int32), dev), SINK_ROWS),
    ]


def _placed_ms(segment, timer, values, rows, n_rows, plan, steps) -> list:
    """K4 with its output at each 512 B step of a buffer (zeroed first)."""
    big = torch.zeros(n_rows + 128 * steps + 256, dtype=values.dtype,
                      device=values.device)
    base = (-big.data_ptr() % 1024) // 4  # words to the first 1 KiB line
    out = []
    for step in range(steps):
        off = base + 128 * step
        col = big[off:off + n_rows]

        def k4(col=col):
            col.zero_()
            _into(segment, values, rows, col, plan)

        out.append({"out_mod_16k": col.data_ptr() % 16384,
                    "ms": timer(k4)})
    return out


def probe_seg_sum(dev, timer, sweep: bool, graph) -> dict:
    from orleans_tpu_torch.kernels import segment

    out = {}
    for name, values, rows, n_rows in k4_cases(dev, graph):
        want = segment.seg_sum_plain(values, rows, n_rows)
        got = segment.seg_sum(values, rows, n_rows)
        if values.dtype == torch.int32:
            ok = torch.equal(got, want)
        else:
            ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-3))
        if not ok:
            raise RuntimeError(f"seg_sum != plain ({name})")
        plan = _plan(segment, rows.shape[0], n_rows, values.dtype)
        pre = torch.zeros(n_rows, dtype=values.dtype, device=dev)
        row = {"plan": plan._asdict() if plan else "direct (one path)",
               "ms": timer(lambda: segment.seg_sum(values, rows, n_rows)),
               "kernel_ms": timer(lambda: _into(segment, values, rows, pre,
                                                plan)),
               "fill_ms": timer(lambda: torch.zeros(
                   n_rows, dtype=values.dtype, device=dev)),
               "index_add_ms": timer(lambda: pre.index_add_(0, rows,
                                                            values))}
        if name.startswith("256 sinks"):
            row["placed"] = _placed_ms(segment, timer, values, rows, n_rows,
                                       plan, 33)
        if name.startswith("chirper"):
            row["placed"] = _placed_ms(segment, timer, values, rows, n_rows,
                                       plan, 2)
        if sweep and plan is not None:
            for cluster, threads, per_sm in SWEEP:
                chunk = -(-n_rows // max(cluster, 1))
                forced = segment.SegPlan(
                    cluster, -(-chunk // 4) * 4 if cluster else 0, threads,
                    per_sm)
                key = f"cluster{cluster}_t{threads}_sm{per_sm}_ms"
                if cluster and 4 * cluster * forced.chunk > 200 * 1024:
                    continue
                try:
                    row[key] = timer(lambda: _into(segment, values, rows,
                                                   pre, forced))
                except RuntimeError as exc:  # a size the card refuses
                    row[key] = str(exc)[:80]
        out[name] = row
    return out


def k8_cases(dev) -> list:
    """(name, counts, cdelta, cms, sdelta, k, n): the smoke's two flushes
    (``chip_smoke.check_attr_kernels``)."""
    from orleans_tpu_torch.kernels import attr
    from orleans_tpu_torch.samples.presence import presence_inputs
    from orleans_tpu_torch.tensor.attribution import CMS_SEEDS

    import chip_smoke as cs

    seeds = CMS_SEEDS[:4]
    m, cap_p = cs.PLAYERS, 1 << 21
    _, games, _ = presence_inputs(cs.PLAYERS, cs.GAMES, seed=0)
    rng = np.random.default_rng(4321)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    def base(*shape):
        return _t(rng.integers(0, 50, shape).astype(np.int32), dev)

    valid = torch.ones(m, dtype=torch.bool, device=dev)
    out = []
    for name, cap, rows, k in (
            ("PresenceGrain, k = 16 on the host", cap_p,
             torch.arange(m, dtype=torch.int32, device=dev), 16),
            ("GameGrain, k read on the device", GAME_ROWS, _t(games, dev),
             torch.tensor([13], dtype=torch.int32, device=dev))):
        cdelta, sdelta, n = zeros(cap), zeros(4, 8192), zeros(1)
        attr.attr_fold(cdelta, sdelta, seeds, rows, valid, total=n)
        out.append((name, base(cap), cdelta, base(4, 8192), sdelta, k, n))
    return out


def probe_attr_apply(dev, timer, sweep: bool) -> dict:
    from orleans_tpu_torch.kernels import attr

    slots = torch.zeros(64, dtype=torch.int32, device=dev)
    out = {}
    for name, counts, cdelta, cms, sdelta, k, n in k8_cases(dev):
        a = [counts.clone(), cms.clone(), slots.clone()]
        b = [counts.clone(), cms.clone(), slots.clone()]
        attr.attr_apply(a[0], cdelta, a[1], sdelta, k, total=a[2], slot=3,
                        n=n)
        attr.attr_apply_plain(b[0], cdelta, b[1], sdelta, k, total=b[2],
                              slot=3, n=n)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise RuntimeError(f"attr_apply != plain ({name})")

        def apply():
            attr.attr_apply(counts, cdelta, cms, sdelta, k, total=slots,
                            slot=3, n=n)

        alpha = k if isinstance(k, int) else int(k[0])
        row = {"ms": timer(apply),
               "add_ms": timer(lambda: counts.add_(cdelta, alpha=alpha))}
        if sweep and hasattr(attr, "apply_plan"):
            saved = (attr.APPLY_BLOCKS_PER_SM, attr.APPLY_EAGER_WORDS,
                     attr.APPLY_MIN_THREADS)
            for eager_words in (0, 1 << 40):
                for min_threads in (64, 256):
                    for per_sm in (2, 4, 8):
                        (attr.APPLY_BLOCKS_PER_SM, attr.APPLY_EAGER_WORDS,
                         attr.APPLY_MIN_THREADS) = (per_sm, eager_words,
                                                    min_threads)
                        row[f"eager{int(eager_words > 0)}_min{min_threads}"
                            f"_sm{per_sm}_ms"] = timer(apply)
            (attr.APPLY_BLOCKS_PER_SM, attr.APPLY_EAGER_WORDS,
             attr.APPLY_MIN_THREADS) = saved
        out[name] = row
    return out


def probe_paths(dev, card: str, graph) -> dict:
    import chip_smoke as cs

    fused = cs.drive_fused_path(dev, card, 0.0, 0.0)
    chirper = cs.drive_chirper_path(dev, card, graph)
    hot = cs.drive_hot_grain_path(dev, card)
    cluster = asyncio.run(cs.cluster_presence(dev, card))
    return {"presence_window_device_ms": fused["window_device_ms"],
            "presence_window_off_device_ms": fused["window_off_device_ms"],
            "chirper_window_device_ms": chirper["fused"]["window_device_ms"],
            "hot_grain_tick_device_ms": {
                name: a["tick_device_ms"] for name, a in hot["arms"].items()},
            "hot_grain_k4_ms": {
                name: a["k4_ms"] for name, a in hot["arms"].items()},
            "hot_grain_window_device_ms": hot["fused"]["window_device_ms"],
            "cluster_device_ms_per_tick":
                cluster["traced"]["device_ms_per_tick"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k4_k8: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from orleans_tpu_torch.device import card_report

    dev = torch.device("cuda")
    card = card_report()
    print(card, flush=True)
    args = sys.argv[1:]
    result = {"card": card}
    graph = cs.chirper_graph()
    if "--paths" in args:
        result["paths"] = probe_paths(dev, card, graph)
    timer = cs.Timer(dev)
    result["seg_sum"] = probe_seg_sum(dev, timer, "--sweep" in args, graph)
    result["attr_apply"] = probe_attr_apply(dev, timer, "--sweep" in args)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
