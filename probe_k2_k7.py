"""K2 ``resolve_sorted`` and K7 ``attr_fold`` taken apart on one CUDA card.

``chip_smoke.py`` holds both kernels against their plain versions and
times them once.  This script reads them beside their library calls at
the shapes of the main path:

* K2: 1,048,576 lanes of Presence's game keys against GameGrain's
  32,768-entry mirror (10,000 live keys), and 1,048,576 lanes (nine in ten
  live keys) against a full mirror of 524,288 random keys (the routing
  sweep's sink count), each beside ``torch.searchsorted``;
* K7: each mode at Presence 1M/10k's shapes (PresenceGrain 2,097,152
  rows, GameGrain 32,768, a 4x8192 sketch) and Chirper's fold of its
  2,011,069 fan-out lanes, each beside its library call where one
  exists, the path ``fold_plan`` chose, and the GameGrain counts fold
  with its column 1 KiB-aligned and 512 B past that (whether the time
  follows the output's address, as K4's does);
* with ``--sweep`` (a tree with the tunables only): K2 by tree depth and
  blocks per SM, K7 by cluster blocks per SM and cluster size, each
  cluster-path shape forced onto the direct path and each direct-path
  shape onto the cluster path, all in this one call.

Times: median over 25 runs, L2 flushed and the stream held by a spin
kernel before each (``chip_smoke.Timer``).  With ``--paths`` it first
drives three of the smoke's paths and reads their device times as the
smoke does: the Presence fused window of 16 with the attribution plane
and without it (phase 5), Chirper's fused window of 16 (phase 7), and
the 2-silo cross-silo Presence's device ms a tick per silo (phase 12,
traced).  Run from the repository root:

    python3 probe_k2_k7.py [--paths] [--sweep]

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

SENTINEL = 2**31 - 1


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def k2_inputs(dev) -> dict:
    """The two mirrors and their lanes (numpy seeds, as the smoke's)."""
    from orleans_tpu_torch.samples.presence import presence_inputs

    import chip_smoke as cs

    _, games, _ = presence_inputs(cs.PLAYERS, cs.GAMES, seed=0)
    cap_g = 1 << 15
    sk = np.full(cap_g, SENTINEL, np.int32)
    sr = np.full(cap_g, -1, np.int32)
    sk[:cs.GAMES] = sr[:cs.GAMES] = np.arange(cs.GAMES)
    rng = np.random.default_rng(5)
    n = 524_288
    big = np.sort(rng.choice(1 << 30, n, replace=False)).astype(np.int32)
    m = 1 << 20
    lanes = np.where(rng.random(m) < 0.9, big[rng.integers(0, n, m)],
                     rng.integers(0, 1 << 30, m)).astype(np.int32)
    return {
        "32768": (_t(sk, dev), _t(sr, dev), _t(games, dev),
                  torch.ones(len(games), dtype=torch.bool, device=dev)),
        "524288": (_t(big, dev), _t(rng.permutation(n).astype(np.int32),
                                    dev), _t(lanes, dev),
                   torch.ones(m, dtype=torch.bool, device=dev)),
    }


def probe_resolve(dev, timer, sweep: bool) -> dict:
    from orleans_tpu_torch.kernels import resolve

    out = {}
    for name, (sk, sr, keys, valid) in k2_inputs(dev).items():
        rows, miss = resolve.resolve_sorted(sk, sr, keys, valid)
        want = resolve.resolve_sorted_plain(sk, sr, keys, valid)
        if not (torch.equal(rows, want[0]) and int(miss) == int(want[1])):
            raise RuntimeError(f"resolve_sorted != plain (mirror {name})")
        row = {"ms": timer(lambda: resolve.resolve_sorted(sk, sr, keys,
                                                          valid)),
               "searchsorted_ms": timer(lambda: torch.searchsorted(sk,
                                                                   keys))}
        if hasattr(resolve, "resolve_plan"):
            row["plan"] = list(resolve.resolve_plan(sk.shape[0]))
        if sweep and hasattr(resolve, "resolve_plan"):
            saved = (resolve.TREE_LEVELS, resolve.SORTED_BLOCKS_PER_SM_RUN,
                     resolve.SORTED_BLOCKS_PER_SM_LIFT)
            for levels in (10, 11, 12):
                for per_sm in (1, 2, 4):
                    resolve.TREE_LEVELS = levels
                    resolve.SORTED_BLOCKS_PER_SM_RUN = per_sm
                    resolve.SORTED_BLOCKS_PER_SM_LIFT = per_sm
                    row[f"levels{levels}_per_sm{per_sm}_ms"] = timer(
                        lambda: resolve.resolve_sorted(sk, sr, keys, valid))
            (resolve.TREE_LEVELS, resolve.SORTED_BLOCKS_PER_SM_RUN,
             resolve.SORTED_BLOCKS_PER_SM_LIFT) = saved
        out[name] = row
    return out


def fold_cases(dev, graph) -> list:
    """(name, counts, cms, rows, valid, kwargs, library call) at the
    smoke's shapes (``chip_smoke.check_attr_kernels``), and Chirper's
    per-tick fold of the fan-out's lanes into the 262,144-row accounts
    arena (every follower row of the follow graph)."""
    from orleans_tpu_torch.samples.presence import presence_inputs

    import chip_smoke as cs

    m = cs.PLAYERS
    cap_p, cap_g = 1 << 21, 1 << 15
    _, games, _ = presence_inputs(cs.PLAYERS, cs.GAMES, seed=0)
    rng = np.random.default_rng(4321)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    def base(*shape):
        return _t(rng.integers(0, 50, shape).astype(np.int32), dev)

    prow = torch.arange(m, dtype=torch.int32, device=dev)
    grow = _t(games, dev)
    valid = torch.ones(m, dtype=torch.bool, device=dev)
    ones = torch.ones(m, dtype=torch.int32, device=dev)
    slots = base(64)
    w_p = zeros(cap_p)
    w_p[:m] = 16
    w_g = _t(16 * np.bincount(games, minlength=cap_g).astype(np.int32), dev)
    crow = _t(graph["dst"].astype(np.int32), dev)
    cones = torch.ones(crow.shape[0], dtype=torch.int32, device=dev)
    cvalid = torch.ones(crow.shape[0], dtype=torch.bool, device=dev)
    return [
        ("counts only, Chirper new_chirp", zeros(1 << 18), None, crow,
         cvalid, dict(total=slots, slot=2),
         lambda c: c.index_add_(0, crow, cones)),
        ("counts only, PresenceGrain", zeros(cap_p), None, prow, valid,
         dict(total=slots, slot=0), lambda c: c.index_add_(0, prow, ones)),
        ("counts only, GameGrain", zeros(cap_g), None, grow, valid,
         dict(total=slots, slot=1), lambda c: c.index_add_(0, grow, ones)),
        ("weighted, PresenceGrain", base(cap_p), base(4, 8192), None, None,
         dict(weight=w_p), lambda c: c.add_(w_p)),
        ("weighted, GameGrain", base(cap_g), base(4, 8192), None, None,
         dict(weight=w_g), lambda c: c.add_(w_g)),
        ("plan, PresenceGrain", zeros(cap_p), zeros(4, 8192), prow, valid,
         dict(total=zeros(1)), None),
        ("full fold, GameGrain", base(cap_g), base(4, 8192), grow, valid,
         dict(total=slots, slot=1), None),
    ]


def probe_fold(dev, timer, sweep: bool, graph) -> dict:
    from orleans_tpu_torch.kernels import attr
    from orleans_tpu_torch.tensor.attribution import CMS_SEEDS

    seeds = CMS_SEEDS[:4]
    has_plan = hasattr(attr, "fold_plan")
    out = {}
    cases = fold_cases(dev, graph)
    for name, counts, cms, rows, valid, kw, lib in cases:
        def fold():
            attr.attr_fold(counts, cms, seeds, rows, valid, **kw)

        row = {"ms": timer(fold),
               "library_ms": timer(lambda: lib(counts)) if lib else None}
        if has_plan:
            w = kw.get("weight")
            m = (w if w is not None else rows).shape[0]
            depth, width = cms.shape if cms is not None else (0, 1)
            plan = attr.fold_plan(m, counts.shape[0], depth, width,
                                  w is not None)
            row["plan"] = plan._asdict()
            if sweep and plan.cluster:
                row.update(_fold_sweep(attr, timer, fold))
            elif sweep:
                min0 = attr.FOLD_MIN_PER_WORD
                attr.FOLD_MIN_PER_WORD = 1
                row["cluster_forced_ms"] = timer(fold)
                attr.FOLD_MIN_PER_WORD = min0
        out[name] = row
    # the GameGrain counts fold at two output addresses
    _, _, _, rows, valid, kw, _ = cases[2]
    buf = torch.zeros((1 << 15) + 1024, dtype=torch.int32, device=dev)
    base = (-buf.data_ptr() % 1024) // 4
    for label, off in (("aligned_1KiB", base), ("plus_512B", base + 128)):
        col = buf[off:off + (1 << 15)]
        out["counts only, GameGrain"][f"{label}_ms"] = timer(
            lambda: attr.attr_fold(col, None, seeds, rows, valid, **kw))
    return out


def _fold_sweep(attr, timer, fold) -> dict:
    """The same call on each grid and cluster size, and forced direct."""
    row = {}
    per_sm0, cluster0 = attr.FOLD_CLUSTER_BLOCKS_PER_SM, attr.FOLD_CLUSTER
    for cluster in (8, 16):
        for per_sm in (1, 2):
            attr.FOLD_CLUSTER, attr.FOLD_CLUSTER_BLOCKS_PER_SM = \
                cluster, per_sm
            try:
                row[f"cluster{cluster}_per_sm{per_sm}_ms"] = timer(fold)
            except RuntimeError as exc:  # a cluster size the card refuses
                row[f"cluster{cluster}_per_sm{per_sm}_ms"] = str(exc)[:80]
    attr.FOLD_CLUSTER, attr.FOLD_CLUSTER_BLOCKS_PER_SM = cluster0, per_sm0
    min0 = attr.FOLD_MIN_PER_WORD
    attr.FOLD_MIN_PER_WORD = 1 << 40
    for per_sm in (4, 8):
        blocks0 = attr.FOLD_BLOCKS_PER_SM
        attr.FOLD_BLOCKS_PER_SM = per_sm
        row[f"direct_per_sm{per_sm}_ms"] = timer(fold)
        attr.FOLD_BLOCKS_PER_SM = blocks0
    attr.FOLD_MIN_PER_WORD = min0
    return row


def probe_paths(dev, card: str, graph) -> dict:
    import chip_smoke as cs

    fused = cs.drive_fused_path(dev, card, 0.0, 0.0)
    chirper = cs.drive_chirper_path(dev, card, graph)
    cluster = asyncio.run(cs.cluster_presence(dev, card))
    return {"presence_window_device_ms": fused["window_device_ms"],
            "presence_window_off_device_ms": fused["window_off_device_ms"],
            "chirper_window_device_ms": chirper["fused"]["window_device_ms"],
            "cluster_device_ms_per_tick":
                cluster["traced"]["device_ms_per_tick"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k2_k7: needs a CUDA card", file=sys.stderr)
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
    result["resolve_sorted"] = probe_resolve(dev, timer, "--sweep" in args)
    result["attr_fold"] = probe_fold(dev, timer, "--sweep" in args, graph)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
