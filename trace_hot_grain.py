"""Per-kernel device time of the routing sample's ticks on one CUDA
card: uniform, every source on one hot sink unreplicated, and the hot sink
spread over a k = 2 and a k = 8 replica group.

The single-hot-grain phase of ``chip_smoke.py`` reads each arm's device
time a tick once, in order.  This script traces blocks of 4 ticks of each
arm (1,048,576 sources, 256 sinks, ledger and attribution plane on, as in
the smoke) with ``torch.profiler``, in two rounds of the arms in turn, and
prints each arm's device time per kernel name, so the difference is read
kernel by kernel and apart from the arm's place in the run.  With each
trace it notes where the tick's ``seg_sum`` outputs lay (their address
modulo 64 KiB).  Last, it times K4 on the uniform arm's rows alone with
the output placed at every 512 B step of 16 KiB, to show how far the
atomics' time follows the output's address.

    python3 trace_hot_grain.py

``trace_arms`` is the traced part alone (``probe_k1_k3.py --paths`` calls
it).
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


ARMS = ("uniform", "hot", "hot_k2", "hot_k8")


def trace_arms(dev, card: str, rounds: int = 2, arms=ARMS) -> tuple:
    """``rounds`` rounds of the routing sample's ``arms`` in turn, each 8
    warm ticks, the held device time of blocks of 4 ticks and one traced
    block; returns (the rounds' results, the engine, the uniform rows and
    values on the card)."""
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from orleans_tpu_torch.kernels import segment
    from orleans_tpu_torch.samples import routing
    # the module, not the decorator the package exports under its name
    vector_grain = sys.modules["orleans_tpu_torch.tensor.vector_grain"]

    sources = np.arange(cs.HOT_SOURCES, dtype=np.int64)
    sinks = routing.sink_keys(cs.HOT_SINKS)
    hot = int(sinks[0])
    uniform = routing.build_ratio_destinations(sources, sinks, 1, 0.0,
                                               seed=3)
    hot_dst = np.full(cs.HOT_SOURCES, hot, np.int64)
    values = np.random.default_rng(20260806).integers(
        1, 8, cs.HOT_SOURCES).astype(np.float32)
    eng = cs._route_engine(dev)
    eng.arena_for("RouteSource").reserve(cs.HOT_SOURCES)
    eng.arena_for("RouteSink").reserve(cs.HOT_SINKS)
    eng.arena_for("RouteSource").resolve_rows(sources)
    eng.arena_for("RouteSink").resolve_rows(sinks)
    inj = eng.make_injector("RouteSource", "send", sources)
    values_d = torch.from_numpy(values).to(dev)
    dst = {"uniform": torch.from_numpy(uniform.astype(np.int32)).to(dev),
           "hot": torch.from_numpy(hot_dst.astype(np.int32)).to(dev)}
    runs = {name: cs.LoadRun(eng, inj, lambda t, d=d: {
        "dst": d, "v": values_d, "tick": np.int32(t)})
        for name, d in dst.items()}
    group = {"uniform": 1, "hot": 1, "hot_k2": 2, "hot_k8": 8,
             "uniform_k8": 8}

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
    for rnd in range(rounds):
        for arm in arms:
            k = group[arm]
            replicas = eng.arena_for("RouteSink")._replicas.get(hot)
            if (1 if replicas is None else len(replicas)) != k:
                if replicas is not None:
                    eng.demote_key("RouteSink", hot)
                if k > 1:
                    cs.require(eng.replicate_key("RouteSink", hot, k) == k,
                               f"k = {k}")
            run = runs["uniform" if arm.startswith("uniform") else "hot"]
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
            # the profiler can lose kernel events of a block (seen once
            # in four probes of eight blocks on an H100): then launches and
            # addresses cannot be paired, and the block says so
            paired = len(k4_runs) == len(placed[-1])
            offsets = [{"out_mod_1k": a % 1024, "out_mod_64k": a,
                        "ms": _device_us(e) / 1e3}
                       for a, e in zip(placed[-1], k4_runs)] if paired else []
            if not paired:
                print(f"    {len(k4_runs)} seg_sum kernels traced for "
                      f"{len(placed[-1])} calls: the trace lost events, "
                      f"addresses not paired", flush=True)
            placed.append(None)
            run.finish()
            per = defaultdict(lambda: [0.0, 0])
            for evt in prof.key_averages():
                us = _device_us(evt)
                if us > 0:
                    per[evt.key][0] += us / 4e3  # ms per tick
                    per[evt.key][1] += evt.count
            traced = sum(v[0] for v in per.values())
            out.append({"round": rnd, "arm": arm, "k": k,
                        "tick_device_ms": dev_ms / 4,
                        "tick_host_ms": host_ms / 4,
                        "traced_device_ms_per_tick": traced,
                        "seg_sum_traced": [len(k4_runs), len(placed[-2])],
                        "seg_sum_runs": offsets,
                        "kernels": {key: {"ms_per_tick": v[0],
                                          "calls": v[1]}
                                    for key, v in sorted(
                                        per.items(),
                                        key=lambda kv: -kv[1][0])}})
            print(f"round {rnd} {arm}: {dev_ms / 4:.4f} ms per tick on the "
                  f"device (held), {traced:.4f} traced; on {card}",
                  flush=True)
            for o in offsets:
                print(f"    seg_sum, output at {o['out_mod_64k']} mod 64 KiB "
                      f"({o['out_mod_1k']} mod 1 KiB): {o['ms']:.4f} ms")
            for key, v in list(out[-1]["kernels"].items())[:12]:
                print(f"    {v['ms_per_tick']:.4f} ms  {v['calls']:5d}  "
                      f"{key[:90]}")
    vector_grain._segment = segment
    if eng.arena_for("RouteSink")._replicas:
        eng.demote_key("RouteSink", hot)
    return out, eng, dst["uniform"], values_d


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_hot_grain: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from orleans_tpu_torch.device import card_report
    from orleans_tpu_torch.kernels import _build, segment

    card = card_report()
    _build.build_all()
    dev = torch.device("cuda")
    out, eng, dst_d, values_d = trace_arms(dev, card)
    uniform = dst_d.cpu().numpy().astype(np.int64)

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
