"""K9 ``attr_snapshot`` and K22 ``gather_args`` taken apart on one CUDA card.

``chip_smoke.py`` times one snapshot of both Presence arenas and K22 at
the 2-way and 3-way ring splits.  This script reads the same kernels at
the same shapes piece by piece:

* K9: each arena's snapshot alone (PresenceGrain 2,097,152 rows, every
  active row at 23; GameGrain 32,768 rows, 23 per player), both together
  beside ``torch.sort`` of both, and the device time per kernel name of
  one snapshot of each arena (``torch.profiler``);
* K22: the Presence payload (game int32, score float32, tick int32) at
  1,048,576 lanes gathered by the 2-way and 3-way ring-ownership
  permutations, each also as one unsplit segment and with the identity
  permutation cut by the same bounds, beside the ``index_select`` loop:
  a difference between the splits shows as the pieces', the lane
  order's or the access pattern's.  Then the identity permutation cut
  into 1 to 9 equal segments, which changes the pieces alone.

Times: median over 25 runs, L2 flushed and the stream held by a spin
kernel before each (``chip_smoke.Timer``).  With ``--paths`` it first
drives two of the smoke's paths and reads their device times as the
smoke does: the Presence fused window of 16 (phase 5, which runs neither
kernel) and the 2-silo cross-silo Presence's device ms a tick per silo
(phase 12, traced; K22 on every inject).  They run before the kernel
probes, so no probe's allocations precede them.  Run from the
repository root:

    python3 probe_k9_k22.py [--paths]

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


def _kernel_times(fn) -> dict:
    """Device microseconds per kernel name of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    from trace_hot_grain import _device_us

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0:
            out[evt.key[:60]] = round(us, 2)
    return out


def probe_snapshot(dev, timer) -> dict:
    from orleans_tpu_torch.kernels import attr
    from orleans_tpu_torch.samples.presence import presence_inputs
    from orleans_tpu_torch.tensor.attribution import CMS_SEEDS

    import chip_smoke as cs

    seeds = CMS_SEEDS[:4]
    rng = np.random.default_rng(4321)
    cms = torch.from_numpy(rng.integers(0, 50, (4, 8192)).astype(
        np.int32)).to(dev)
    _, games, _ = presence_inputs(cs.PLAYERS, cs.GAMES, seed=0)
    snap_p = torch.zeros(1 << 21, dtype=torch.int32, device=dev)
    snap_p[:cs.PLAYERS] = 23
    snap_g = torch.from_numpy(23 * np.bincount(
        games, minlength=1 << 15).astype(np.int32)).to(dev)
    return {
        "presence_ms": timer(lambda: attr.attr_snapshot(snap_p, cms, seeds,
                                                        16)),
        "game_ms": timer(lambda: attr.attr_snapshot(snap_g, cms, seeds, 16)),
        "both_ms": timer(lambda: (attr.attr_snapshot(snap_p, cms, seeds, 16),
                                  attr.attr_snapshot(snap_g, cms, seeds,
                                                     16))),
        "torch_sort_both_ms": timer(lambda: (
            torch.sort(snap_p, descending=True, stable=True),
            torch.sort(snap_g, descending=True, stable=True))),
        "presence_kernels_us": _kernel_times(
            lambda: attr.attr_snapshot(snap_p, cms, seeds, 16)),
        "game_kernels_us": _kernel_times(
            lambda: attr.attr_snapshot(snap_g, cms, seeds, 16)),
    }


def probe_gather(dev, timer) -> dict:
    from orleans_tpu_torch.kernels import router as kr

    import chip_smoke as cs

    rng = np.random.default_rng(2222)
    n = cs.K22_LANES
    keys = np.arange(n, dtype=np.int64)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    leaves = [t(rng.integers(0, cs.GAMES, n).astype(np.int32)),
              t(rng.random(n, dtype=np.float32)),
              t(np.full(n, 7, np.int32))]
    ident = torch.arange(n, dtype=torch.int32, device=dev)
    out = {}
    for ways in (2, 3):
        perm, bounds = cs._ring_split(keys, ways)
        perm_d = t(perm)
        perm_l = perm_d.long()
        out[f"{ways}_way"] = {
            "segments": [b - a for a, b in zip(bounds, bounds[1:])],
            "split_ms": timer(lambda: kr.gather_args(leaves, perm_d,
                                                     bounds)),
            "unsplit_ms": timer(lambda: kr.gather_args(leaves, perm_d)),
            "identity_split_ms": timer(lambda: kr.gather_args(
                leaves, ident, bounds)),
            "index_select_ms": timer(lambda: [
                lf.index_select(0, perm_l) for lf in leaves]),
        }
    out["identity_equal_segments_ms"] = {
        str(k): timer(lambda: kr.gather_args(
            leaves, ident, [n * i // k for i in range(k + 1)]))
        for k in range(1, 10)}
    return out


def probe_paths(dev, card: str) -> dict:
    import chip_smoke as cs

    fused = cs.drive_fused_path(dev, card, 0.0, 0.0)
    cluster = asyncio.run(cs.cluster_presence(dev, card))
    return {"presence_window_device_ms": fused["window_device_ms"],
            "cluster_device_ms_per_tick":
                cluster["traced"]["device_ms_per_tick"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k9_k22: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from orleans_tpu_torch.device import card_report

    dev = torch.device("cuda")
    card = card_report()
    print(card, flush=True)
    result = {"card": card}
    if "--paths" in sys.argv[1:]:
        result["paths"] = probe_paths(dev, card)
    timer = cs.Timer(dev)
    result["attr_snapshot"] = probe_snapshot(dev, timer)
    result["gather_args"] = probe_gather(dev, timer)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
