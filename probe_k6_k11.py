"""K6 ``miss_keys`` and K11 ``fanout_expand`` taken apart on one CUDA
card.

``chip_smoke.py`` holds both kernels against their plain versions and
times them once.  This script reads them beside their library calls at
the shapes of the main paths:

* K6 at the cold Presence tick (1,000,000 lanes over 10,000 games, every
  lane missing, ``MISS_BUF`` 131,072) and at the cluster inject's shape
  (the same lanes with the games of the remote silo missing: 5,000
  unique misses over about half the lanes), beside ``torch.unique``;
* K11 at the Chirper shape (200,000 accounts publishing through the
  follow graph of mean 25 followers, Zipf 1.6) and at the streams push
  shape (4,096 chat rooms publishing through the push CSR of 1,000,000
  users at 1.5 memberships), beside ``torch.repeat_interleave`` (the
  slots' source lanes only).

With ``--split`` it traces each call with ``torch.profiler`` and prints
the device time of every CUDA launch in it by kernel name.  With
``--paths`` it first drives the paths that run the two kernels and reads
their device times as the smoke does: Chirper's fused window of 16
(phase 7), the cluster phase's device ms a tick per silo (phase 12) and a
chat window of 16 published past the bound key set, so that every tick
takes the push path through K11; each with its K6 and K11 launches.  It
runs in the repository root:

    python3 probe_k6_k11.py [--split] [--paths]

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

PUSH_WINDOW = 16
SPLIT_CALLS = 20


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def k6_inputs(dev) -> dict:
    """The cold tick's lanes (every game missing) and the cluster
    inject's (the odd games live on the remote silo and miss; the even
    ones resolve to their rows)."""
    import chip_smoke as cs
    from orleans_tpu_torch.samples.presence import presence_inputs

    _, games, _ = presence_inputs(cs.PLAYERS, cs.GAMES, seed=0)
    keys = _t(games, dev)
    remote = (games % 2) == 1
    return dict(keys=keys,
                cold_rows=torch.full_like(keys, -1),
                cluster_rows=_t(np.where(remote, -1, games)
                                .astype(np.int32), dev),
                valid=torch.ones_like(keys, dtype=torch.bool),
                cluster_misses=int(remote.sum()))


def _k6(x: dict, rows: str):
    from orleans_tpu_torch.kernels import miss
    from orleans_tpu_torch.tensor.engine import MISS_BUF

    return lambda: miss.miss_keys(x["keys"], x[rows], x["valid"], MISS_BUF)


def probe_k6(dev, timer) -> dict:
    import chip_smoke as cs
    from orleans_tpu_torch.tensor.engine import MISS_BUF

    x = k6_inputs(dev)
    m = x["keys"].shape[0]
    out = {"lanes": m, "miss_buf": MISS_BUF,
           "bound_ms": cs.bound(10 * m + 4 * MISS_BUF)[0]}
    for name in ("cold", "cluster"):
        rows = x[f"{name}_rows"]
        out[f"{name}_ms"] = timer(_k6(x, f"{name}_rows"))
        out[f"{name}_library_ms"] = timer(lambda: torch.unique(torch.where(
            (rows < 0) & x["valid"], x["keys"], cs.SENTINEL), sorted=True))
    out["cluster_missing_lanes"] = x["cluster_misses"]
    return out


def push_csr(dev) -> tuple:
    """The streams plane's push CSR (``DeviceSubscriptions.push_csr``) of
    the smoke's chat layout."""
    import chip_smoke as cs
    from orleans_tpu_torch.samples.streams import build_membership
    from orleans_tpu_torch.tensor.streams_plane import DeviceSubscriptions

    subs = DeviceSubscriptions(None, "ChatUserGrain", "receive")
    subs.subscribe_many(*build_membership(cs.CHAT_ROOMS, cs.CHAT_USERS,
                                          cs.CHAT_MEAN, seed=0))
    return subs.push_csr(dev)


def k11_inputs(dev, graph: dict) -> dict:
    import chip_smoke as cs

    chirper = graph["fan"].csr(dev)
    push = push_csr(dev)
    return dict(
        chirper=(*chirper,
                 torch.arange(cs.ACCOUNTS, dtype=torch.int32, device=dev),
                 torch.ones(cs.ACCOUNTS, dtype=torch.bool, device=dev)),
        push=(*push, push[0].clone(),
              torch.ones(push[0].shape[0], dtype=torch.bool, device=dev)))


def _k11(args):
    from orleans_tpu_torch.kernels import fanout as kfan

    return lambda: kfan.fanout_expand(*args)


def probe_k11(dev, timer, x: dict) -> dict:
    import chip_smoke as cs

    out = {}
    for name, args in x.items():
        keys, offsets, dst, src, _valid = args
        n_src, width, m = keys.shape[0], dst.shape[0], src.shape[0]
        deg = torch.zeros(m, dtype=torch.int64, device=dev)
        idx = torch.searchsorted(keys, src).clamp_(max=n_src - 1)
        hit = keys[idx] == src
        deg[hit] = (offsets[idx + 1] - offsets[idx]).long()[hit]
        total = int(deg.sum())
        lanes = torch.arange(m, device=dev)
        out[name] = {
            "shape": {"n_src": n_src, "width": width, "lanes": m,
                      "total": total},
            "ms": timer(_k11(args)),
            "bound_ms": cs.bound(8 * n_src + 4 + 13 * width + 6 * m + 8)[0],
            "library_ms": timer(lambda: torch.repeat_interleave(
                lanes, deg, output_size=total))}
    return out


def _short(name: str) -> str:
    """A CUDA kernel's name without its namespace, template or arguments."""
    return name.replace("(anonymous namespace)::", "").split("(")[0] \
        .split("<")[0].split("::")[-1].split()[-1]


def _timeline(fn) -> list:
    """One call's CUDA work in start order, as ``torch.profiler`` reads the
    last of three calls after a warm one: [kernel, µs from the call's
    first start to its start, device µs].  A launch that starts before the one ahead of it
    ends (programmatic dependent launch) shows as an overlap."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    events = events[len(events) - len(events) // 3:]  # the last call's
    t0 = events[0].time_range.start if events else 0
    return [[_short(e.name), e.time_range.start - t0,
             e.time_range.end - e.time_range.start] for e in events]


def probe_split(dev, k11: dict) -> dict:
    """Device µs a call by kernel name (``chip_smoke._split_us``) and a
    timeline of one call, for each kernel at each shape."""
    import chip_smoke as cs

    x = k6_inputs(dev)
    out = {"k6_cold_us": cs._split_us(_k6(x, "cold_rows"), SPLIT_CALLS),
           "k6_cluster_us": cs._split_us(_k6(x, "cluster_rows"),
                                         SPLIT_CALLS),
           "k6_cold_timeline": _timeline(_k6(x, "cold_rows"))}
    for name, args in k11.items():
        out[f"k11_{name}_us"] = cs._split_us(_k11(args), SPLIT_CALLS)
        out[f"k11_{name}_timeline"] = _timeline(_k11(args))
    return out


def _k6_k11_launches() -> dict:
    from orleans_tpu_torch.kernels import _build

    return {k: v for k, v in _build.launch_report().items()
            if k in ("miss_keys", "fanout_expand")}


def push_window(dev) -> dict:
    """Chat, 4,096 rooms over 1,000,000 users at 1.5 memberships, as the
    smoke's streams phase wires it, but with the subscriptions bound to
    the rooms in reverse order: the publish key set is not the bound one,
    so every tick takes the push path (K11 over the push CSR).  A fused
    window of 16 ticks, its device time read as ``chip_smoke.Timer``
    reads a call, and every delivery verified."""
    import chip_smoke as cs
    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.samples.streams import wire_chat
    from orleans_tpu_torch.tensor.engine import TensorEngine

    engine = TensorEngine(device=dev, config=TensorEngineConfig(
        auto_fusion_ticks=0))
    rooms = np.arange(cs.CHAT_ROOMS, dtype=np.int64)
    subs = wire_chat(engine, cs.CHAT_ROOMS, cs.CHAT_USERS, cs.CHAT_MEAN)
    subs.bind(rooms[::-1].copy())
    prog = engine.fuse_ticks("ChatRoomGrain", "publish", rooms)
    n = cs.CHAT_ROOMS

    def stacked(base: int) -> dict:
        return {"msg_id": (
            torch.arange(PUSH_WINDOW, dtype=torch.int32, device=dev)[:, None]
            * n + torch.arange(n, dtype=torch.int32, device=dev)[None]
            + base * n * PUSH_WINDOW)}

    prog.run(stacked(0))  # the build and its warm window
    engine.wait_completion()
    inputs = stacked(1)
    ms = cs.Timer(dev)(lambda: prog.run(inputs), reps=5)
    engine.wait_completion()
    misses = prog.verify()
    cs.require(misses == 0, f"push window missed {misses} deliveries")
    k11 = _build.launch_report()["fanout_expand"]
    cs.require(k11["captured"] > 0, "the push window never went push")
    out = {"window_device_ms": ms, "edges": subs.edge_count,
           "fanout_expand_captured": k11["captured"]}
    del prog, engine
    torch.cuda.empty_cache()
    return out


def probe_paths(dev, card: str, graph: dict) -> dict:
    import chip_smoke as cs
    from orleans_tpu_torch.kernels import _build

    out = {}
    _build.reset_launch_counts()
    chirper = cs.drive_chirper_path(dev, card, graph)
    out["chirper_window_device_ms"] = chirper["fused"]["window_device_ms"]
    out["chirper_launches"] = _k6_k11_launches()
    _build.reset_launch_counts()
    cluster = asyncio.run(cs.cluster_presence(dev, card))
    out["cluster_device_ms_per_tick"] = \
        cluster["traced"]["device_ms_per_tick"]
    out["cluster_launches"] = _k6_k11_launches()
    _build.reset_launch_counts()
    out["push_window"] = push_window(dev)
    out["push_launches"] = _k6_k11_launches()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k6_k11: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from orleans_tpu_torch.device import card_report
    from orleans_tpu_torch.kernels import _build

    dev = torch.device("cuda")
    card = card_report()
    print(card, flush=True)
    _build.build_all()
    args = sys.argv[1:]
    graph = cs.chirper_graph()
    result = {"card": card}
    if "--paths" in args:
        result["paths"] = probe_paths(dev, card, graph)
    timer = cs.Timer(dev)
    k11 = k11_inputs(dev, graph)
    result["miss_keys"] = probe_k6(dev, timer)
    result["fanout_expand"] = probe_k11(dev, timer, k11)
    if "--split" in args:
        result["split"] = probe_split(dev, k11)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
