"""Per-kernel device time of the routing sample's uniform tick, with and
without a live k = 8 replica group, on one CUDA card.

The single-hot-grain phase of ``chip_smoke.py`` reads the uniform tick
at different device times with and without a live group, and at
different places in the run.  This script
traces blocks of 4 uniform ticks (1,048,576 sources, 256 sinks, ledger
and attribution plane on, as in the smoke) with ``torch.profiler``,
alternating the two arms in one process (plain, k = 8, plain, k = 8),
and prints each arm's device time per kernel name, so the difference is
read kernel by kernel and apart from the arm's place in the run.  With
each trace it notes where the tick's ``seg_sum`` outputs lay (their
address modulo 64 KiB).  Last, it times K4 on the uniform arm's rows
alone with the output placed at every 512 B step of 16 KiB, to show how
far the atomics' time follows the output's address.

    python3 trace_hot_grain.py
"""

from __future__ import annotations

import gc
import json
import sys
import types
from collections import defaultdict

import numpy as np
import torch


def _device_us(evt) -> float:
    """Device time of a kernel or copy event; 0 for a host op (whose own
    device total would count its kernels a second time)."""
    from torch.autograd import DeviceType

    if evt.device_type != DeviceType.CUDA:
        return 0.0
    # older torch names the totals after CUDA
    for attrs in (("self_device_time_total", "device_time_total"),
                  ("self_cuda_time_total", "cuda_time_total")):
        if hasattr(evt, attrs[0]):
            return max(float(getattr(evt, a)) for a in attrs)
    return 0.0


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_hot_grain: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from orleans_tpu_torch.device import card_report
    from orleans_tpu_torch.kernels import _build, segment
    from orleans_tpu_torch.samples import routing
    # the module, not the decorator the package exports under its name
    vector_grain = sys.modules["orleans_tpu_torch.tensor.vector_grain"]

    card = card_report()
    _build.build_all()
    dev = torch.device("cuda")
    sources = np.arange(cs.HOT_SOURCES, dtype=np.int64)
    sinks = routing.sink_keys(cs.HOT_SINKS)
    hot = int(sinks[0])
    uniform = routing.build_ratio_destinations(sources, sinks, 1, 0.0,
                                               seed=3)
    values = np.random.default_rng(20260806).integers(
        1, 8, cs.HOT_SOURCES).astype(np.float32)
    eng = cs._route_engine(dev)
    eng.arena_for("RouteSource").reserve(cs.HOT_SOURCES)
    eng.arena_for("RouteSink").reserve(cs.HOT_SINKS)
    eng.arena_for("RouteSource").resolve_rows(sources)
    eng.arena_for("RouteSink").resolve_rows(sinks)
    inj = eng.make_injector("RouteSource", "send", sources)
    dst_d = torch.from_numpy(uniform.astype(np.int32)).to(dev)
    values_d = torch.from_numpy(values).to(dev)
    run = cs.LoadRun(eng, inj, lambda t: {
        "dst": dst_d, "v": values_d, "tick": np.int32(t)})

    # a grain's seg_sum reaches K4 through vector_grain's module handle:
    # note where each output lands while a trace runs
    placed = []

    def noting_seg_sum(values, rows, n_rows):
        got = segment.seg_sum(values, rows, n_rows)
        if placed and placed[-1] is not None:
            placed[-1].append(got.data_ptr() % 65536)
        return got

    vector_grain._segment = types.SimpleNamespace(seg_sum=noting_seg_sum)
    out = []
    for rnd, arm in enumerate(("uniform", "uniform_k8") * 2):
        if arm == "uniform_k8":
            cs.require(eng.replicate_key("RouteSink", hot, 8) == 8, "k = 8")
        elif eng.arena_for("RouteSink")._replicas:
            eng.demote_key("RouteSink", hot)
        for _ in range(8):  # warm: the injector's refresh, the allocator
            run.tick()
        run.finish()
        gc.collect()

        def block():
            for _ in range(4):
                run.tick()

        dev_ms, host_ms = cs.held_device_ms(block, reps=5,
                                            prepare=eng._drain_checks)
        run.finish()
        eng._drain_checks()
        torch.cuda.synchronize()
        placed.append([])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            block()
            torch.cuda.synchronize()
        # each seg_sum launch of the trace beside its output's address
        # (one stream: the kernels run in call order)
        k4_runs = sorted((e for e in prof.events()
                          if _device_us(e) > 0
                          and ("seg_private_kernel" in e.name
                               or "seg_direct_kernel" in e.name)),
                         key=lambda e: e.time_range.start)
        offsets = [{"out_mod_1k": a % 1024, "out_mod_64k": a,
                    "ms": _device_us(e) / 1e3}
                   for a, e in zip(placed[-1], k4_runs)]
        cs.require(len(k4_runs) == len(placed[-1]),
                   f"{len(k4_runs)} seg_sum kernels traced for "
                   f"{len(placed[-1])} calls")
        placed.append(None)
        run.finish()
        per = defaultdict(lambda: [0.0, 0])
        for evt in prof.key_averages():
            us = _device_us(evt)
            if us > 0:
                per[evt.key][0] += us / 4e3  # ms per tick
                per[evt.key][1] += evt.count
        traced = sum(v[0] for v in per.values())
        out.append({"round": rnd, "arm": arm,
                    "tick_device_ms": dev_ms / 4,
                    "tick_host_ms": host_ms / 4,
                    "traced_device_ms_per_tick": traced,
                    "seg_sum_runs": offsets,
                    "kernels": {k: {"ms_per_tick": v[0], "calls": v[1]}
                                for k, v in sorted(
                                    per.items(), key=lambda kv: -kv[1][0])}})
        print(f"round {rnd} {arm}: {dev_ms / 4:.4f} ms per tick on the "
              f"device (held), {traced:.4f} traced; on {card}", flush=True)
        for o in offsets:
            print(f"    seg_sum, output at {o['out_mod_64k']} mod 64 KiB "
                  f"({o['out_mod_1k']} mod 1 KiB): {o['ms']:.4f} ms")
        for k, v in list(out[-1]["kernels"].items())[:12]:
            print(f"    {v['ms_per_tick']:.4f} ms  {v['calls']:5d}  {k[:90]}")
    vector_grain._segment = segment

    # K4 alone on the uniform rows, the output at each 512 B step
    sink = eng.arena_for("RouteSink")
    rows_d = torch.from_numpy(
        sink.lookup_rows(uniform)[0].astype(np.int32)).to(dev)
    n_rows = sink.capacity
    plan = segment.seg_plan(rows_d.shape[0], n_rows, 1, torch.float32)
    big = torch.zeros(64 << 10, dtype=torch.float32, device=dev)
    base = big.data_ptr() % 65536
    timer = cs.Timer(dev)
    sweep = []
    for step in range(33):
        off = step * 128  # floats: 512 B

        def k4(off=off):
            out = big[off:off + n_rows]
            out.zero_()
            segment.launch(values_d, rows_d, out, plan)

        ms = timer(k4)
        sweep.append({"out_mod_64k": (base + 4 * off) % 65536, "ms": ms})
    want = segment.seg_sum_plain(values_d, rows_d, n_rows)
    k4()
    torch.cuda.synchronize()
    cs.require(bool(torch.allclose(big[4096:4096 + n_rows], want,
                                   rtol=1e-6)), "the sweep's K4 is wrong")
    ms = [r["ms"] for r in sweep]
    print(f"K4 float32 alone on the uniform rows ({rows_d.shape[0]} lanes, "
          f"{n_rows} rows), output at 33 steps of 512 B: min "
          f"{min(ms):.4f}, median {float(np.median(ms)):.4f}, max "
          f"{max(ms):.4f} ms; on {card}", flush=True)
    for r in sweep:
        print(f"    out at {r['out_mod_64k']:6d} mod 64 KiB: {r['ms']:.4f} ms")
    print(json.dumps({"card": card, "rounds": out, "k4_sweep": sweep}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
