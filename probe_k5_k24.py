"""K24 ``exchange_buckets`` and K5 ``hist_count`` taken apart on one CUDA
card.

``chip_smoke.py`` holds both kernels against their plain versions and
times them once.  This script reads them beside their library calls at
the shapes of the main path:

* K24 at the routing sweep's shape (4,000,000 lanes into 8 blocks, L =
  524,288, the sink leg at ratio 0.5, the path's two 4-byte leaves) in
  the legacy layout at the sweep's grant and in the per-destination
  layout, beside the smoke's composite (stable ``argsort`` +
  ``index_put_`` + ``index_select``);
* K5 on a 1,000,000-lane batch with rows (the unfused tick's count) and
  on the mask alone (the in-window form), beside ``torch.sum`` +
  ``index_add_``; where the tree has ``hist_count_many``, a fused tick's
  three counts in one launch beside three single counts.

With ``--split`` it traces each call with ``torch.profiler`` and prints
the device time of every CUDA launch in it by kernel name (K24's
histogram, scan and write, and its fill where the fill is a launch of its
own), and the fill's cost as a difference the parent's tree can read too:
the write at ratio 0 (no cross lane, so every bucket lane is a fill) at
the sweep's grant against the same at cap 1.  With ``--paths`` it first
drives the smoke's paths that run the two kernels and reads their device
times as the smoke does: the Presence fused window of 16 with and without
the attribution plane (phase 5), Chirper's fused window (phase 7), chat's
fused window (phase 9), the routing sweep's fused windows of 4 at ratio
0.5 with the exchange structured and off (phase 13), and the sweep's
throughput point; each with its K5 and K24 launches.  It runs in the
repository root:

    python3 probe_k5_k24.py [--split] [--paths]

Times: median over 25 runs, L2 flushed and the stream held by a spin
kernel before each (``chip_smoke.Timer``).  It prints the card's name and
power limit, then one JSON object.  The script runs on any tree of the
port with these wrappers (copy it into an older tree), so two trees can
be compared in one call.
"""

from __future__ import annotations

import asyncio
import json
import sys

import numpy as np
import torch

K5_LANES = 1_000_000
SPLIT_CALLS = 20


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def k24_inputs(dev, ratio: float = 0.5) -> dict:
    """The smoke's K24 shape (``chip_smoke.check_exchange_kernels``): the
    sink leg's lanes at ``ratio``, the path's two leaves, the legacy grant
    and the per-destination grants and receive rung the sweep's estimator
    gives this demand."""
    import chip_smoke as cs
    from orleans_tpu_torch.kernels import exchange as kx
    from orleans_tpu_torch.tensor.exchange import _SiteEstimator, ladder_ceil

    n, m = cs.EX_BLOCKS, cs.EX_SOURCES
    L = ladder_ceil(-(-m // n))
    sc = 2 * (cs.EX_SINKS // n)
    rng = np.random.default_rng(13013)
    rows_np, mask_np = cs._ex_sink_lanes(rng, m, L, sc, ratio)
    rows, mask = _t(rows_np, dev), _t(mask_np, dev)
    leaves = [_t(rng.integers(1, 8, m).astype(np.float32), dev),
              _t(np.ones(m, np.int32), dev)]
    fit = kx.exchange_buckets(rows, mask, leaves[:1], sc, L, n, cap=L)
    need = fit[4].cpu().numpy()[3:]
    est = _SiteEstimator(n)
    est.observe(need[:n], 1.5, 4, inbound=need[n:])
    return dict(rows=rows, mask=mask, leaves=leaves, sc=sc, L=L, n=n, m=m,
                cap=max(1, min(L, int(est.grant))),
                caps=[min(L, int(c)) for c in est.grants],
                R=max(1, ladder_ceil(min(int(est.recv_grant), n * L))))


def _k24(x: dict, **plan):
    from orleans_tpu_torch.kernels import exchange as kx

    return lambda: kx.exchange_buckets(x["rows"], x["mask"], x["leaves"],
                                       x["sc"], x["L"], x["n"], **plan)


def _k24_bytes(x: dict, W: int) -> int:
    # rows, mask and 8 B of leaves in; the same over n W lanes out; dropped
    return x["m"] * 13 + x["n"] * W * 13 + x["m"]


def probe_k24(dev, timer) -> dict:
    import chip_smoke as cs

    x = k24_inputs(dev)
    n, L, m = x["n"], x["L"], x["m"]
    W_leg, W_pd = L + n * x["cap"], L + x["R"]
    sdest = torch.where(x["rows"] >= 0, x["rows"].long() // x["sc"], n)
    sdest = torch.nn.functional.pad(sdest, (0, n * L - m), value=n) \
        .view(n, L)
    out_rows = torch.empty(n * W_leg, dtype=torch.int32, device=dev)
    slot = torch.randperm(n * W_leg, device=dev)[:n * L]

    def composite():
        order = torch.argsort(sdest, dim=1, stable=True)
        flat = (order + torch.arange(n, device=dev).view(n, 1) * L) \
            .view(-1).clamp_(max=m - 1)
        out_rows.index_put_((slot,), x["rows"][flat])
        for leaf in x["leaves"]:
            leaf.index_select(0, flat)

    return {"shape": {"lanes": m, "L": L, "blocks": n, "cap": x["cap"],
                      "W": W_leg, "caps": x["caps"], "R": x["R"]},
            "legacy_ms": timer(_k24(x, cap=x["cap"])),
            "legacy_bound_ms": cs.bound(_k24_bytes(x, W_leg))[0],
            "perdest_ms": timer(_k24(x, caps=x["caps"], R=x["R"])),
            "perdest_bound_ms": cs.bound(_k24_bytes(x, W_pd))[0],
            "composite_ms": timer(composite)}


def k5_inputs(dev) -> dict:
    rng = np.random.default_rng(55)
    m = K5_LANES
    return dict(
        hist=torch.zeros((64, 16), dtype=torch.int32, device=dev),
        totals=torch.zeros((1, 2), dtype=torch.int32, device=dev),
        base=_t(rng.random(m) < 0.9, dev),
        rows=_t(np.where(rng.random(m) < 0.1, -1,
                         rng.integers(0, m, m)).astype(np.int32), dev),
        emask=_t(rng.random(m) < 0.8, dev), m=m)


def _many_entries(y: dict) -> list:
    """A fused Presence tick's three counts: the ledger's applied lanes of
    the two groups and the emit's delivered lanes."""
    return [(y["hist"], 9, 0, y["base"], None),
            (y["totals"], 0, 1, y["emask"], None),
            (y["hist"], 3, 0, y["emask"], None)]


def probe_k5(dev, timer) -> dict:
    import chip_smoke as cs
    from orleans_tpu_torch.kernels import hist

    y = k5_inputs(dev)
    cell = torch.tensor([9 * 16 + 4], dtype=torch.int64, device=dev)
    flat = y["hist"].view(-1)
    base, rows, m = y["base"], y["rows"], y["m"]
    out = {"rows_ms": timer(lambda: hist.hist_count(y["hist"], 9, 4, base,
                                                    rows)),
           "rows_bound_ms": cs.bound(m * 5 + 4)[0],
           "rows_library_ms": timer(lambda: flat.index_add_(
               0, cell, ((rows >= 0) & base).sum(dtype=torch.int32)
               .view(1))),
           "mask_ms": timer(lambda: hist.hist_count(y["hist"], 9, 4, base)),
           "mask_bound_ms": cs.bound(m + 4)[0],
           "mask_library_ms": timer(lambda: flat.index_add_(
               0, cell, base.sum(dtype=torch.int32).view(1)))}
    entries = _many_entries(y)

    def singles():
        for h, s, b, mk, r in entries:
            hist.hist_count(h, s, b, mk, r)

    out["tick_three_singles_ms"] = timer(singles)
    out["tick_bound_ms"] = cs.bound(3 * m + 12)[0]
    if hasattr(hist, "hist_count_many"):
        out["tick_many_ms"] = timer(lambda: hist.hist_count_many(entries))
    return out


def _traced_by_name(fn) -> dict:
    """Device µs a call of every CUDA kernel ``fn`` launches, by name
    (``chip_smoke._split_us`` over ``SPLIT_CALLS`` calls)."""
    import chip_smoke as cs

    return cs._split_us(fn, SPLIT_CALLS)


def probe_split(dev) -> dict:
    from orleans_tpu_torch.kernels import hist

    x = k24_inputs(dev)
    out = {"k24_legacy_us": _traced_by_name(_k24(x, cap=x["cap"])),
           "k24_perdest_us": _traced_by_name(_k24(x, caps=x["caps"],
                                                  R=x["R"]))}
    # the fill: at ratio 0 no lane crosses, so every bucket lane is empty
    local = k24_inputs(dev, 0.0)
    out["k24_ratio0_grant_us"] = _traced_by_name(_k24(local, cap=x["cap"]))
    out["k24_ratio0_cap1_us"] = _traced_by_name(_k24(local, cap=1))
    out["fill_lanes_at_grant"] = x["n"] * x["n"] * x["cap"]
    y = k5_inputs(dev)
    out["k5_rows_us"] = _traced_by_name(
        lambda: hist.hist_count(y["hist"], 9, 4, y["base"], y["rows"]))
    out["k5_mask_us"] = _traced_by_name(
        lambda: hist.hist_count(y["hist"], 9, 4, y["base"]))
    if hasattr(hist, "hist_count_many"):
        entries = _many_entries(y)
        out["k5_many_us"] = _traced_by_name(
            lambda: hist.hist_count_many(entries))
    return out


def _k5_k24_launches() -> dict:
    from orleans_tpu_torch.kernels import _build

    return {k: v for k, v in _build.launch_report().items()
            if k.startswith(("hist_count", "exchange_buckets"))}


def probe_paths(dev, card: str) -> dict:
    import chip_smoke as cs
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.samples import routing

    out = {}
    _build.reset_launch_counts()
    fused = cs.drive_fused_path(dev, card, 0.0, 0.0)
    out["presence_window_device_ms"] = fused["window_device_ms"]
    out["presence_window_off_device_ms"] = fused["window_off_device_ms"]
    out["presence_launches"] = _k5_k24_launches()
    _build.reset_launch_counts()
    chirper = cs.drive_chirper_path(dev, card, cs.chirper_graph())
    out["chirper_window_device_ms"] = chirper["fused"]["window_device_ms"]
    out["chirper_launches"] = _k5_k24_launches()
    _build.reset_launch_counts()
    streams = cs.drive_streams_path(dev, card, cs.Timer(dev))
    out["chat_window_device_ms"] = streams["fused"]["window_device_ms"]
    out["chat_launches"] = _k5_k24_launches()
    # the sweep's fused windows of 4 at ratio 0.5, structured and off
    cs.EX_RATIOS = (0.5,)
    sources = np.arange(cs.EX_SOURCES, dtype=np.int64)
    sinks = routing.sink_keys(cs.EX_SINKS)
    values = np.random.default_rng(1).integers(1, 8, cs.EX_SOURCES) \
        .astype(np.float32)
    shared = dict(sources=sources, sinks=sinks, values=values,
                  values_d=torch.from_numpy(values).to(dev),
                  dst={0.5: routing.build_ratio_destinations(
                      sources, sinks, cs.EX_BLOCKS, 0.5, seed=0)},
                  src_cross=0)
    for arm in ("always", "off"):
        r = cs._ex_sweep_arm(dev, card, arm, True, shared)
        out[f"sweep_{arm}_fused_window_device_ms"] = \
            r["ratios"][0.5]["window_device_ms"]
        out[f"sweep_{arm}_fused_messages_per_sec"] = \
            r["ratios"][0.5]["messages_per_sec"]
        out[f"sweep_{arm}_launches"] = {
            k: v for k, v in r["report"].items()
            if k.startswith(("hist_count", "exchange_buckets"))}
    # the throughput point (262,144 / 8,192, ratio 0.1, windows of 64)
    _build.reset_launch_counts()
    tp_n, tp_s, tp_r, tp_ticks, tp_w = cs.EX_TP
    eng = cs._ex_engine(dev, exchange_structured="always")
    st = asyncio.run(routing.run_routing_load(eng, tp_n, tp_s, tp_r,
                                              n_ticks=tp_ticks,
                                              fused_window=tp_w))
    out["throughput_messages_per_sec"] = st["messages_per_sec"]
    out["throughput_launches"] = _k5_k24_launches()
    del eng
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k5_k24: needs a CUDA card", file=sys.stderr)
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
    result["exchange_buckets"] = probe_k24(dev, timer)
    result["hist_count"] = probe_k5(dev, timer)
    if "--split" in args:
        result["split"] = probe_split(dev)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
