"""Auto-fusion: the engine detects its own steady state and fuses it.

The port of ``orleans_tpu/tensor/autofuse.py``.  The loader calls nothing
but ``injector.inject(args)`` per tick, and the engine

1. **detects** K consecutive ticks carrying an identical injection
   pattern — same (type, method), same key set, same arena generation,
   same args dict with a stable static/per-tick split (a leaf is static
   while it is the same object and, for a tensor, its in-place version
   counter has not moved: unlike a JAX array, a tensor can be refreshed
   in place);
2. **builds** the steady tick into a ``FusedTickProgram`` (on the card: a
   CUDA graph of ``auto_fusion_window`` ticks) and switches to window
   mode: injections buffer their per-tick leaves and every window of
   ticks runs as ONE replay;
3. **verifies** the windows' device-side miss total once per
   ``auto_fusion_verify_windows`` windows and, on a nonzero count (a cold
   destination or a round-cap spill inside a window), **rolls back** the
   chain from a pin of the state taken at its start and replays its
   ticks through the exact unfused path;
4. **disengages** on any pattern break, replaying buffered ticks unfused
   one at a time, so per-tick application order holds.

The latency ledger and the workload-attribution plane accumulate inside
the windows; a rollback restores both from the chain's pin.  A window
advances the tick clock by whole windows, so the engine's periodic
write-back cadence (``checkpoint_every_ticks``) is honoured after each
one — verifying the chain first: a write taken before verification could
persist a window that later rolls back.

On a clustered silo the signature carries the ring's version: a pattern
fuses only while every source key is ring-owned here (checked when a
window program is built), and a ban, whether for remote keys or for
repeated rollbacks, holds until the ring changes.
"""

from __future__ import annotations

import time
import weakref
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from orleans_tpu_torch.tensor.engine import PendingBatch
from orleans_tpu_torch.tensor.fused import FusedTickProgram


def pin_copy(cols: Dict[str, torch.Tensor],
             pins: Dict[str, torch.Tensor]) -> None:
    """The rollback pin of a chain: one copy of an arena's state columns
    into preallocated pin buffers, before the chain's first window runs.
    Windows update the live columns in place, so a pin by reference would
    read the post-window values at rollback.  Device-to-device copies
    only, no arithmetic."""
    for name, col in cols.items():
        pins[name].copy_(col)


def _per_source(prog: FusedTickProgram, per: List[Any]) -> Any:
    """``run``/``prepare`` take lists for a multi-source program, the one
    element otherwise."""
    return per if prog._is_multi() else per[0]


def _version(v: Any) -> Optional[int]:
    """A tensor's in-place version counter (bumped by every in-place
    write to it or a view of it); None for any other leaf."""
    return v._version if isinstance(v, torch.Tensor) else None


def _snapshot(v: Any) -> Any:
    """A buffered per-tick leaf as it is at its tick: tensors and arrays
    are copied (on the tensor's own stream, no sync), since the window
    reads them later and the loader may refresh them in place."""
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, np.ndarray):
        return v.copy()
    return v


def _stack(values: List[Any]) -> Any:
    """One per-tick leaf over a window's ticks: ``[T, ...]``."""
    if all(isinstance(v, torch.Tensor) for v in values):
        return torch.stack(values)
    return np.stack([v.cpu().numpy() if isinstance(v, torch.Tensor)
                     else np.asarray(v) for v in values])


class _PatternState:
    """Per-(type, method) detection/engagement state of one steady
    injection stream.  A steady tick may carry several streams; the fuser
    tracks the set and builds ONE window applying every stream per tick,
    in canonical order."""

    __slots__ = ("key", "sig", "prev_top", "prev_versions", "static_keys",
                 "rows", "keys_host", "generation", "epoch", "static_args")

    def __init__(self, key: Tuple[str, str], sig: Tuple,
                 args: Dict[str, Any], b: PendingBatch) -> None:
        self.key = key
        self.sig = sig
        self.prev_top = dict(args)
        self.prev_versions = {k: _version(v) for k, v in args.items()}
        self.static_keys = set(args)
        self.rows = b.rows
        self.keys_host = b.keys_host
        self.generation = b.generation
        self.epoch = b.epoch
        self.static_args: Dict[str, Any] = {}


class AutoFuser:

    def __init__(self, engine) -> None:
        self.engine = engine
        # detection state: the steady SET of patterns (sorted by
        # (type, method)) and a composite signature over all of them
        self._sig: Optional[Tuple] = None
        self._count = 0
        self._patterns: List[_PatternState] = []
        self._activation_passes = -1
        # engaged-window state
        self._program: Optional[FusedTickProgram] = None
        # per tick, one per-tick-leaf dict PER PATTERN
        self._buffer: List[List[Dict[str, Any]]] = []
        self._replaying = False
        # verification chain: windows whose miss totals are unread
        self._unverified: List[List[List[Dict[str, Any]]]] = []
        self._chain_prog: Optional[FusedTickProgram] = None
        self._chain_counters: Optional[Tuple[int, int]] = None
        self._chain_generations: Dict[str, int] = {}
        self._chain_epochs: Dict[str, int] = {}
        self._chain_ledger: Optional[Tuple] = None
        self._chain_attr: Optional[Tuple] = None
        # caches / stats
        self._programs: Dict[Tuple, FusedTickProgram] = {}
        # pin buffers per program: arena → column → copy
        self._pins: Dict[int, Dict[str, Dict[str, torch.Tensor]]] = {}
        # banned signatures → the ring version they were banned at
        self._disabled: Dict[Tuple, int] = {}
        # rollback hysteresis: cumulative rollbacks per signature
        self._rollback_counts: Dict[Tuple, int] = {}
        # identity-memoized CONTENT digests of key arrays: a loader
        # recreating its injector (fresh array, same keys) keeps its
        # signature; the weakref guards against id() reuse
        self._digest_cache: Dict[int, Tuple[Any, int]] = {}
        # engage-time copies of static tensor leaves, per (signature,
        # pattern, leaf): (weakref to the loader's tensor, its version,
        # the copy).  A re-engagement on the same unchanged tensor reuses
        # the copy, so the program's graph stays valid.
        self._frozen: Dict[Tuple, Tuple[Any, int, torch.Tensor]] = {}
        self.windows_run = 0
        self.windows_rolled_back = 0
        self.ticks_fused = 0

    def _keys_digest(self, arr: np.ndarray) -> int:
        key = id(arr)
        ent = self._digest_cache.get(key)
        if ent is not None and ent[0]() is arr:
            self._digest_cache[key] = self._digest_cache.pop(key)  # LRU
            return ent[1]
        digest = hash((len(arr), arr.tobytes()))
        try:
            ref = weakref.ref(arr)
        except TypeError:  # non-weakrefable array subclass: no memo
            return digest
        while len(self._digest_cache) >= 256:
            self._digest_cache.pop(next(iter(self._digest_cache)))
        self._digest_cache[key] = (ref, digest)
        return digest

    # ================= detection ==========================================

    def _ring_version(self) -> int:
        silo = self.engine.silo
        return silo.ring.version if silo is not None else 0

    def _reset(self) -> None:
        self._sig = None
        self._count = 0
        self._patterns = []
        self._program = None

    def has_buffer(self) -> bool:
        return bool(self._buffer) or bool(self._unverified)

    def idle_flush(self) -> None:
        """Engine-loop idle path: the producer stopped mid-window — drain
        every buffered tick through the unfused path now."""
        self._break()

    def _break(self) -> None:
        """Pattern break: settle the verification chain (it may roll back
        and replay), then replay any remaining buffered ticks — all BEFORE
        the breaking tick executes."""
        self._settle_chain()
        if self._buffer:
            self._replay_buffer()
        self._reset()

    def _replay_buffer(self) -> None:
        """Drain the window buffer through the unfused path, one engine
        tick per buffered tick.  Newer queued work is stashed and restored
        BEHIND the replayed ticks, so ordering holds even when foreign
        traffic broke the pattern mid-window."""
        engine = self.engine
        stash = engine.queues
        engine.queues = defaultdict(list)
        try:
            while self.flush_partial():
                engine.run_tick()
                # follow-on rounds past the round cap spill, as the
                # unfused engine's cap does (bounded, never a hang)
                for _ in range(engine.config.max_rounds_per_tick):
                    if not any(engine.queues.values()):
                        break
                    engine.run_tick()
        finally:
            self._replaying = False
            for k, v in stash.items():
                if v:
                    engine.queues[k].extend(v)

    def _scan_live(self) -> Optional[List[Tuple]]:
        """``[(key, batch, args, psig)]`` sorted by (type, method) when
        EVERY live queue carries exactly one fusable injection batch,
        else None."""
        live = sorted((k, v) for k, v in self.engine.queues.items() if v)
        if not live:
            return None
        entries = []
        for key, batches in live:
            if len(batches) != 1:
                return None
            b = batches[0]
            args = b.args
            if (b.future is not None or b.rows is None
                    or b.keys_host is None or b.no_fanout
                    or b.mask is not None or not isinstance(args, dict)):
                return None
            arena = self.engine.arenas.get(key[0])
            if arena is None or b.generation != arena.generation \
                    or b.epoch != arena.eviction_epoch:
                # stale rows (growth or eviction since resolution): not
                # fusable this tick; the injector revalidates on its next
                # inject and detection resumes
                return None
            psig = (key[0], key[1], self._keys_digest(b.keys_host),
                    b.generation, tuple(sorted(args)))
            entries.append((key, b, args, psig))
        return entries

    def offer(self) -> bool:
        """Called at tick start.  True when the tick's work was consumed
        into the fused window (the caller skips the unfused path)."""
        cfg = self.engine.config
        if cfg.auto_fusion_ticks <= 0 or self._replaying:
            return False
        entries = self._scan_live()
        if entries is None:
            self._break()
            return False
        sig = (tuple(e[3] for e in entries), self._ring_version())
        if self._disabled.get(sig) == self._ring_version():
            self._break()
            return False

        def seed() -> None:
            self._sig = sig
            self._count = 1
            self._patterns = [_PatternState(key, psig, args, b)
                              for key, b, args, psig in entries]
            self._activation_passes = self.engine.activation_passes

        if sig != self._sig:
            self._break()
            seed()
            return False
        # same signature again: refine every pattern's static split by
        # leaf identity and tensor version
        shrunk_engaged = False
        for pat, (_key, _b, args, _psig) in zip(self._patterns, entries):
            versions = {k: _version(v) for k, v in args.items()}
            new_static = {k for k in pat.static_keys
                          if args[k] is pat.prev_top.get(k)
                          and versions[k] == pat.prev_versions.get(k)}
            if self._program is not None \
                    and not set(pat.static_args) <= new_static:
                # a leaf static at engage time changed identity or was
                # written in place: the window applies its engage-time
                # copy to every buffered tick, which is right for them but
                # not for this tick.  Disengage, replay the buffer,
                # restart detection here.
                shrunk_engaged = True
            pat.static_keys = new_static
            pat.prev_top = dict(args)
            pat.prev_versions = versions
        if shrunk_engaged:
            self._break()
            seed()
            return False
        self._count += 1
        threshold = 2 if sig in self._programs else cfg.auto_fusion_ticks
        if self._count < threshold:
            return False
        if self.engine._pending_checks:
            # outstanding miss-checks may still activate cold destinations:
            # settle them before building against the directory mirror
            self.engine._drain_checks()
        if self.engine.activation_passes != self._activation_passes:
            # recent drains still activated cold grains — not steady yet
            self._activation_passes = self.engine.activation_passes
            self._count = 1
            return False
        if all(len(pat.static_keys) == len(e[2])
               for pat, e in zip(self._patterns, entries)):
            return False  # nothing varies per tick: no window axis
        if self._program is None and not self._engage(sig, entries):
            return False
        for key, _b, _args, _p in entries:
            self.engine.queues[key].clear()
        self._buffer.append([
            {k: _snapshot(v) for k, v in args.items()
             if k not in pat.static_keys}
            for pat, (_key, _b, args, _p) in zip(self._patterns, entries)])
        if len(self._buffer) >= cfg.auto_fusion_window:
            self._run_window()
        return True

    def _engage(self, sig: Tuple, entries: List[Tuple]) -> bool:
        prog = self._programs.get(sig)
        if prog is not None and (
                len(prog.sources) != len(entries)
                or any(not np.array_equal(s.keys, e[1].keys_host)
                       for s, e in zip(prog.sources, entries))):
            prog = None  # content-digest collision: never reuse blindly
        if prog is None:
            # clustered silos: every source's key set must be entirely
            # ring-owned here (the contract of engine.fuse_ticks)
            router = self.engine.router
            if router is not None:
                for key, b, _args, _p in entries:
                    _local, remote = router.partition(key[0], b.keys_host)
                    if remote:
                        self._disabled[sig] = self._ring_version()
                        self._reset()
                        return False
            prog = FusedTickProgram.multi(
                self.engine,
                [(key[0], key[1], b.keys_host)
                 for key, b, _args, _p in entries])
            self._programs[sig] = prog
        for i, (pat, (_key, _b, args, _p)) in enumerate(
                zip(self._patterns, entries)):
            pat.static_args = {k: self._freeze((sig, i, k), args[k])
                               for k in pat.static_keys}
        # build NOW (discovery, and on the card the graph capture), so the
        # cost lands on the engagement tick, not a steady window.  The
        # example window repeats this tick's per-tick leaves.
        W = self.engine.config.auto_fusion_window
        example = [{k: _stack([v] * W) for k, v in args.items()
                    if k not in pat.static_keys}
                   for pat, (_key, _b, args, _p)
                   in zip(self._patterns, entries)]
        prog.prepare(_per_source(prog, example), _per_source(
            prog, [pat.static_args for pat in self._patterns]))
        self._program = prog
        return True

    def _freeze(self, key: Tuple, v: Any) -> Any:
        """The static leaf the window and every replay of its buffered
        ticks read: for a tensor, a copy taken at engage time, so a later
        in-place refresh of the loader's tensor (which breaks the pattern
        at its tick) cannot reach ticks buffered before it."""
        if not isinstance(v, torch.Tensor):
            return v
        ent = self._frozen.get(key)
        if ent is not None and ent[0]() is v and ent[1] == v._version:
            return ent[2]
        copy = v.clone()
        self._frozen[key] = (weakref.ref(v), v._version, copy)
        return copy

    # ================= window execution ====================================

    def _pins_for(self, prog: FusedTickProgram
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
        """The program's pin buffers, (re)allocated when a column's shape
        changed (growth rebuilds the program first)."""
        pins = self._pins.setdefault(id(prog), {})
        for n in prog._touched:
            state = self.engine.arena_for(n).state
            cur = pins.get(n)
            if cur is None or any(c not in cur or cur[c].shape != v.shape
                                  for c, v in state.items()):
                pins[n] = {c: torch.empty_like(v) for c, v in state.items()}
        return pins

    def _run_window(self) -> None:
        engine = self.engine
        prog = self._program
        t0 = time.perf_counter()
        # a generation or epoch change since the build settles the chain
        # BEFORE this window leaves the buffer: a rollback's replay then
        # drains the chained ticks AND this window unfused
        if not prog._built or any(
                engine.arena_for(n).generation != g
                for n, g in prog._generations.items()) or any(
                engine.arena_for(n).eviction_epoch != e
                for n, e in prog._epochs.items()):
            self._settle_chain()
            if self._program is None or not self._patterns:
                return  # rolled back: the buffer was replayed unfused
        window = self._buffer
        self._buffer = []
        stackeds = [{k: _stack([w[i][k] for w in window])
                     for k in window[0][i]}
                    for i in range(len(self._patterns))]
        statics = [pat.static_args for pat in self._patterns]
        # rebuild BEFORE the chain pin: re-resolution can activate source
        # keys and grow an arena, which would make the pin unrestorable
        prog.prepare(_per_source(prog, stackeds),
                     _per_source(prog, statics))
        if self._chain_prog is None:
            # chain start: the rollback pin
            pins = self._pins_for(prog)
            for n in prog._touched:
                pin_copy(engine.arena_for(n).state, pins[n])
            self._chain_prog = prog
            self._chain_counters = (engine.tick_number,
                                    engine.messages_processed)
            self._chain_generations = {
                n: engine.arena_for(n).generation for n in prog._touched}
            self._chain_epochs = {
                n: engine.arena_for(n).eviction_epoch
                for n in prog._touched}
            # the ledger and the attribution plane accumulate INSIDE the
            # windows: a rollback undoes those counts too (the unfused
            # replay records every message).  The attribution pin is a
            # copy into preallocated buffers, as pin_copy's.
            self._chain_ledger = engine.ledger.snapshot_state()
            self._chain_attr = engine.attribution.snapshot_state()
        prog.run(_per_source(prog, stackeds), _per_source(prog, statics))
        self._unverified.append(window)
        if engine.checkpoint_due():
            # verify before a due write: a clean settle makes it an exact
            # restore point; a rollback replays unfused ticks, which write
            # at their own boundaries, and this covers any remainder
            self._settle_chain()
            engine.maybe_periodic_checkpoint()
        dt = time.perf_counter() - t0
        self.windows_run += 1
        for _ in range(len(window)):
            # every message of the window completes by its end: the window
            # wall time is each tick's (conservative) latency
            engine.tick_durations.append(dt)
        if len(self._unverified) >= max(
                1, engine.config.auto_fusion_verify_windows):
            self._settle_chain()

    def _settle_chain(self) -> None:
        """Read the chain's device miss total (ONE device read for up to
        verify_windows windows).  Zero: the chain was exact.  Nonzero:
        restore the pin and replay every chained tick (then any newer
        buffered tick, in order) through the unfused path."""
        if not self._unverified:
            return
        engine = self.engine
        prog = self._chain_prog
        windows, self._unverified = self._unverified, []
        counters = self._chain_counters
        generations = self._chain_generations
        epochs = self._chain_epochs
        ledger_state = self._chain_ledger
        attr_state = self._chain_attr
        self._chain_prog = None
        self._chain_counters = None
        self._chain_generations = {}
        self._chain_epochs = {}
        self._chain_ledger = None
        self._chain_attr = None
        misses = prog.verify()
        n_ticks = sum(len(w) for w in windows)
        if misses == 0:
            self.ticks_fused += n_ticks
            # a clean chain forgives earlier strikes
            self._rollback_counts.pop(self._sig, None)
            return
        if any(engine.arena_for(n).generation != g
               for n, g in generations.items()) or any(
               engine.arena_for(n).eviction_epoch != e
               for n, e in epochs.items()):
            # every row move settles the chain first
            # (GrainArena._settle_owner_chain): reaching here is a bug
            raise RuntimeError(
                "autofuse: arena repacked mid-chain — a row move bypassed "
                "_settle_owner_chain; the rollback pin is unrestorable")
        self.windows_rolled_back += 1
        pins = self._pins[id(prog)]
        for n in generations:
            # restore INTO the live columns: the window's graph keeps
            # their addresses, and the pin buffers stay the pin's
            live = engine.arena_for(n).state
            for c, pin in pins[n].items():
                live[c].copy_(pin)
        engine.tick_number, engine.messages_processed = counters
        engine.ledger.restore_state(ledger_state)
        # in place: the window's graph keeps the accumulators' addresses
        engine.attribution.restore_state(attr_state)
        sig = self._sig
        strikes = self._rollback_counts.get(sig, 0) + 1
        self._rollback_counts[sig] = strikes
        if strikes >= max(1, engine.config.auto_fusion_max_rollbacks):
            # hysteresis: a pattern that keeps rolling back pays for
            # fusion without getting it — ban it until the ring changes
            # (a generation change gives it a new signature too)
            self._disabled[sig] = self._ring_version()
            self._pins.pop(id(self._programs.pop(sig, prog)), None)
            for k in [k for k in self._frozen if k[0] == sig]:
                del self._frozen[k]
        # chained ticks replay FIRST, then any newer buffered ticks
        self._buffer = [t for w in windows for t in w] + self._buffer
        self._replay_buffer()
        self._reset()

    # ================= drain integration ==================================

    def flush_partial(self) -> bool:
        """Re-enqueue ONE buffered tick for exact unfused replay (the
        engine's flush calls this until it returns False).  Settles the
        verification chain first — flush means FULL delivery."""
        if self._unverified and not self._replaying:
            self._settle_chain()
            return True
        if not self._buffer:
            self._replaying = False
            return False
        self._replaying = True
        tick_args = self._buffer.pop(0)
        for pat, per_tick in zip(self._patterns, tick_args):
            self.engine.queues[pat.key].append(PendingBatch(
                args={**pat.static_args, **per_tick},
                rows=pat.rows,
                keys_host=pat.keys_host,
                generation=pat.generation,
                epoch=pat.epoch,
                # the replayed tick enters the unfused ledger path now,
                # counted once (its window never ran)
                inject_tick=self.engine.tick_number))
        return True

    def snapshot(self) -> Dict[str, int]:
        return {
            "windows_run": self.windows_run,
            "windows_rolled_back": self.windows_rolled_back,
            "ticks_fused": self.ticks_fused,
        }
