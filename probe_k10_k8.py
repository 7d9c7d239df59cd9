"""K10 ``resolve_wide`` and K8 ``attr_match`` taken apart on one CUDA
card.

``chip_smoke.py`` holds both kernels against their plain versions and
times them once.  This script reads them at the shapes of the main paths
and beside inputs that leave out one stage each:

* K10 at WidePresence's mirror (10,000 wide game keys in an arena of
  32,768 rows) and 1,000,000 lanes; the same lanes all invalid (no
  probes: the search, the lanes' loads and stores); against a mirror of
  one key (no search to speak of); in narrow mode (int32 lanes against a
  mirror of 10,000 int keys); against a mirror of 2,048 rows (the whole
  mirror in the search tree) and one of 524,288 rows (300,000 keys, the
  bucket search lifting in L2); and K2 ``resolve_sorted`` on the main
  mirror's hashes, which is the search and one gather alone;
* K8's match at the smoke's shape (16 GameGrain entries of 1,000,000
  lanes, two of them stale: one at lane 12,345, one at the last lane),
  at 1 and 32 matching entries, 16 entries all stale, and 16 entries
  whose views start one word past the plan's alignment.

With ``--split`` it traces each call with ``torch.profiler`` and prints
the device time of every CUDA launch in it by kernel name.  With
``--paths`` it first drives the paths that run the two kernels and reads
their device times as the smoke does: WidePresence unfused and auto-fused
(phase 6: one K10 a tick; the fused window of 16) and the unfused
Presence tick in blocks of 16 with the attribution plane off, with its
folds host-proven, and with the game emits' folds checked on the device
(a loader that hands the engine a fresh copy of the games every tick;
one checked flush a block: K8's match, its apply and the gated K7
folds).  It runs in the repository root:

    python3 probe_k10_k8.py [--split] [--paths]

Times: median over 25 runs, L2 flushed and the stream held by a spin
kernel before each (``chip_smoke.Timer``).  It prints the card's name and
power limit, then one JSON object.  The script runs on any tree of the
port with these wrappers (copy it into an older tree), so two trees can
be compared in one call.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

SPLIT_CALLS = 20


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _mirror(dev, keys: np.ndarray, capacity=None) -> tuple:
    """``device_index_wide`` of a WideGame arena holding ``keys``."""
    from orleans_tpu_torch.samples import presence_wide  # noqa: F401
    from orleans_tpu_torch.tensor.arena import GrainArena
    from orleans_tpu_torch.tensor.vector_grain import vector_type

    if capacity is None:
        arena = GrainArena(vector_type("WideGame"), dev)
        arena.reserve(len(keys))
    else:
        arena = GrainArena(vector_type("WideGame"), dev, capacity=capacity)
    arena.resolve_rows(keys)
    return arena.device_index_wide()


def k10_inputs(dev) -> dict:
    """Each case's live keys and arguments of ``resolve_wide`` (mirror, hi,
    lo, valid)."""
    import chip_smoke as cs

    rng = np.random.default_rng(17)
    wide = cs.wide_inputs()
    main = _mirror(dev, wide["games"])
    hi, lo = _t(wide["hi"], dev), _t(wide["lo"], dev)
    ones = torch.ones(cs.PLAYERS, dtype=torch.bool, device=dev)
    one_key = _mirror(dev, wide["games"][:1], capacity=1)
    narrow_keys = np.unique(rng.integers(0, 2**31 - 1, 10_000))
    n_main = len(wide["games"])
    cases = {
        "main": (n_main, (*main, hi, lo, ones)),
        "main_invalid": (n_main, (*main, hi, lo, torch.zeros_like(ones))),
        "one_key": (1, (*one_key, hi, lo, ones)),
        "narrow": (len(narrow_keys), (
            *_mirror(dev, narrow_keys), None,
            _t(rng.choice(narrow_keys, cs.PLAYERS).astype(np.int32), dev),
            ones)),
    }
    for name, (n_keys, mirror, v_hi, v_lo) in \
            cs.wide_variant_mirrors(dev).items():
        cases[name] = (n_keys, (*mirror, v_hi, v_lo, ones))
    return cases


def _k10(args):
    from orleans_tpu_torch.kernels import resolve

    return lambda: resolve.resolve_wide(*args)


def probe_k10(dev, timer, cases: dict) -> dict:
    import chip_smoke as cs
    from orleans_tpu_torch.kernels import resolve

    out = {}
    for name, (n_keys, args) in cases.items():
        sorted_h, rows_by_h, hi_col, lo_col, hi, lo, valid = args
        got = resolve.resolve_wide(*args)
        want = resolve.resolve_wide_plain(*args)
        cs.require(torch.equal(got[0], want[0])
                   and int(got[1]) == int(want[1]),
                   f"resolve_wide != plain ({name})")
        m = lo.shape[0]
        out[name] = {
            "mirror": sorted_h.shape[0], "keys": n_keys, "lanes": m,
            "misses": int(want[1]),
            "ms": timer(_k10(args)),
            "bound_ms": cs.wide_bound(n_keys, m, narrow=hi is None)[0]}
    # K2 on the main mirror's hashes: its search and one gather
    sorted_h, rows_by_h, _, _, hi, lo, valid = cases["main"][1]
    h = resolve.mix32(hi, lo)
    out["k2_on_main_hashes_ms"] = timer(
        lambda: resolve.resolve_sorted(sorted_h, rows_by_h, h, valid))
    return out


def k8_inputs(dev) -> dict:
    """Each case's (rows_list, valid_list, plan_rows, plan_valid)."""
    import chip_smoke as cs
    from orleans_tpu_torch.samples.presence import presence_inputs

    _, games, _ = presence_inputs(cs.PLAYERS, cs.GAMES, seed=0)
    m = cs.PLAYERS
    grow = _t(games, dev)
    valid = torch.ones(m, dtype=torch.bool, device=dev)

    r16, v16 = cs.match_stacks(grow, valid, 16)
    r16[3][12345] += 1
    v16[11][m - 1] = False
    stale_r, stale_v = cs.match_stacks(grow, valid, 16)
    for r in stale_r:
        r[0] += 1
    return {"k16_two_stale": (r16, v16, grow, valid),
            "k1": (*cs.match_stacks(grow, valid, 1), grow, valid),
            "k32": (*cs.match_stacks(grow, valid, 32), grow, valid),
            "k16_all_stale": (stale_r, stale_v, grow, valid),
            "k16_odd_offset": (*cs.match_stacks(grow, valid, 16, odd=True),
                               grow, valid)}


def _k8(args, flags, km):
    from orleans_tpu_torch.kernels import attr

    rows, valid, plan_rows, plan_valid = args
    return lambda: attr.attr_match(rows, valid, plan_rows, plan_valid,
                                   flags, km)


def probe_k8(dev, timer, cases: dict) -> dict:
    import chip_smoke as cs
    from orleans_tpu_torch.kernels import attr

    out = {}
    for name, (rows, valid, plan_rows, plan_valid) in cases.items():
        k, m = len(rows), plan_rows.shape[0]
        got = [torch.full((k,), 7, dtype=torch.int32, device=dev),
               torch.zeros(1, dtype=torch.int32, device=dev)]
        want = [torch.full((k,), 7, dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev)]
        attr.attr_match(rows, valid, plan_rows, plan_valid, *got)
        attr.attr_match_plain(rows, valid, plan_rows, plan_valid, *want)
        cs.require(all(torch.equal(a, b) for a, b in zip(got, want)),
                   f"attr_match != plain ({name})")
        out[name] = {"entries": k, "lanes": m, "km": int(want[1][0]),
                     "ms": timer(_k8((rows, valid, plan_rows, plan_valid),
                                     *got)),
                     "bound_ms": cs.bound((k + 1) * 5 * m + 4 * k + 4)[0]}
    return out


def probe_split(k10: dict, k8: dict, dev) -> dict:
    """Device µs a call by kernel name (``chip_smoke._split_us``)."""
    import chip_smoke as cs

    out = {}
    for name, (_, args) in k10.items():
        out[f"k10_{name}_us"] = cs._split_us(_k10(args), SPLIT_CALLS)
    for name, args in k8.items():
        flags = torch.zeros(len(args[0]), dtype=torch.int32, device=dev)
        km = torch.zeros(1, dtype=torch.int32, device=dev)
        out[f"k8_match_{name}_us"] = cs._split_us(_k8(args, flags, km),
                                                  SPLIT_CALLS)
    return out


def _launches() -> dict:
    from orleans_tpu_torch.kernels import _build

    return {k: v for k, v in _build.launch_report().items()
            if k in ("resolve_wide", "attr_match", "attr_apply",
                     "attr_fold")}


def presence_plane_ms(dev, n_ticks: int = 16, reps: int = 3) -> dict:
    """Device ms a tick of blocks of ``n_ticks`` steady unfused Presence
    ticks (``chip_smoke.FusedRun`` with auto-fusion off): ``off`` without
    the attribution plane, ``proven`` with it and one loader tensor of
    games (every fold host-proven, K8's apply), ``checked`` with a fresh
    copy of the games every tick (the game emits' folds checked on the
    device: K8's match, its apply and the gated K7 folds, one flush of 32
    folds every 16 ticks).  Samples in turns, the order reversed every
    other time; the medians, and the launches over the timed blocks."""
    import chip_smoke as cs
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.samples.presence import presence_inputs

    _, games, scores = presence_inputs(cs.PLAYERS, cs.GAMES, seed=0)
    runs = {"off": cs.FusedRun(dev, games, scores, attribution=False,
                               fuse=False),
            "proven": cs.FusedRun(dev, games, scores, fuse=False),
            "checked": cs.FusedRun(dev, games, scores, moving=True,
                                   fuse=False)}

    def block(run):
        def go():
            for _ in range(n_ticks):
                run.tick()
        return go

    for run in runs.values():  # settle: one flush each
        block(run)()
        run.engine._drain_checks()
    _build.reset_launch_counts()
    times = {k: [] for k in runs}
    order = list(runs)
    for _ in range(reps):
        for key in order + order[::-1]:
            times[key].append(cs.held_device_ms(
                block(runs[key]), reps=1,
                prepare=runs[key].engine._drain_checks)[0])
    out = {k: float(np.median(v)) / n_ticks for k, v in times.items()}
    launches = _launches()
    for run in runs.values():
        run.finish()
    return {"tick_device_ms": out, "launches": launches}


def probe_paths(dev, card: str) -> dict:
    """WidePresence unfused and fused (the smoke's phase 6), and the
    unfused Presence tick with the plane off, proven and checked."""
    import chip_smoke as cs
    from orleans_tpu_torch.kernels import _build

    out = {}
    _build.reset_launch_counts()
    wide = cs.drive_wide_path(dev, card, cs.wide_inputs())
    out["wide_window_device_ms"] = wide["fused"]["window_device_ms"]
    out["wide_unfused_tick_device_ms"] = wide["unfused"]["tick_device_ms"]
    out["wide_launches"] = _launches()
    plane = presence_plane_ms(dev)
    out["presence_tick_device_ms"] = plane["tick_device_ms"]
    out["presence_plane_launches"] = plane["launches"]
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k10_k8: needs a CUDA card", file=sys.stderr)
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
    k10 = k10_inputs(dev)
    k8 = k8_inputs(dev)
    result["resolve_wide"] = probe_k10(dev, timer, k10)
    result["attr_match"] = probe_k8(dev, timer, k8)
    if "--split" in args:
        result["split"] = probe_split(k10, k8, dev)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
