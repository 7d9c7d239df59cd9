"""Device-resident timers/reminders plane: a hierarchical hashed timing
wheel over per-type due-time slot columns.

The port of ``orleans_tpu/tensor/timers_plane.py`` (reference analog:
LocalReminderService + ReminderTable semantics, MSR-TR-2014-41 §3.6;
wheel structure: Varghese & Lauck, SOSP '87).  Each armed timer is a slot
in per-type int32 columns (``key``/``due``/``name``/``period``) on the
card, bucketed on the host into a hierarchical hashed wheel keyed by
engine tick.  Each engine tick pays O(due now) host work — the due
buckets' slot lists — and one K15 ``timers_harvest`` launch per type with
due slots, which

- gathers key/due/name/period at the due slots,
- re-arms periodic timers (phase-preserving: the next due lands strictly
  after ``now`` on the ``start + k * period`` grid, so missed periods
  coalesce into one fire),
- frees fired one-shots (key := sentinel),
- and leaves the fired ``(key, name_id)`` vectors on the card, injected
  into the ordinary dispatch as one batched ``receive_reminder`` call
  (``PendingBatch(keys_dev=..., mask=fired)``) at the power-of-two padded
  width the JAX plane uses.  A fire to an evicted grain re-activates it
  through the optimistic-miss machinery like any other message: a
  reminder survives deactivation.

Arms and cancels write the four columns with one K14 ``timers_write``
launch.  Wheel shape (``config.timers_wheel_bits``, default ``(8, 6,
6)``): 256 one-tick buckets, 64 of 256 ticks, 64 of 16384 ticks; later
deadlines park in an overflow list re-examined at top-level cascade
boundaries.  An entry sits at the lowest level whose span covers its
delta, so the next visit of its bucket is its due revolution.  Bucket
entries are (slot, stamp) pairs with lazy deletion: cancel bumps the
slot's stamp and the entry dies at harvest, so cancel is O(1) and slot
reuse never double-fires.  Slots are keyed by grain key, not arena row,
so evictions and row moves need no timer hook.

The checkpoint ride-along (``tensor/checkpoint.py``): every arm and
cancel made while a snapshot store is attached is logged (``_record``,
bounded by ``config.timers_ops_cap``); a cut exports either the compact
live slots at absolute dues (full) or the op log since the previous cut
(delta), ``restore_entry`` applies a recovered cut to the host mirrors and
``finish_restore`` retires what was due at or before the cut, rebuilds the
wheels and uploads the columns once, so journal replay re-fires everything
due after the cut exactly once.  A cross-silo handoff moves armed timers
with their grains (``export_keys`` / ``adopt_keys``: remaining ticks
relative to each engine's clock); migration between shard blocks of one
arena belongs to the multi-shard slice of the port.
"""

from __future__ import annotations

import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from orleans_tpu_torch.device import host_upload, pow2_pad
from orleans_tpu_torch.kernels.timers import (
    SENTINEL,
    timers_harvest,
    timers_write,
)

METHOD = "receive_reminder"
_SENT = int(SENTINEL)

OP_ARM = 0
OP_CANCEL = 1



def _pad_vals(vals: np.ndarray, n: int, fill, dtype) -> np.ndarray:
    out = np.full(n, fill, dtype)
    out[:len(vals)] = vals
    return out


class _Wheel:
    """Host-side hierarchical hashed wheel over SLOT ids (the dues live in
    the owning type's host mirror — ``due_of``/``stamp_ok`` close over
    it).  Buckets hold (slots, stamps) np-array chunks; nothing is
    concatenated until harvest.  A copy of the JAX plane's wheel."""

    __slots__ = ("bits", "shifts", "masks", "spans", "levels",
                 "overflow", "tick", "due_of", "stamp_ok")

    def __init__(self, bits: Tuple[int, ...], tick: int,
                 due_of, stamp_ok) -> None:
        self.bits = tuple(bits)
        self.shifts = [sum(bits[:l]) for l in range(len(bits))]
        self.masks = [(1 << b) - 1 for b in bits]
        self.spans = [1 << (self.shifts[l] + bits[l])
                      for l in range(len(bits))]
        self.levels = [[[] for _ in range(1 << b)] for b in bits]
        self.overflow: List[Tuple[np.ndarray, np.ndarray]] = []
        self.tick = tick
        self.due_of = due_of
        self.stamp_ok = stamp_ok

    def place(self, slots: np.ndarray, stamps: np.ndarray,
              dues: np.ndarray) -> None:
        """Place at the lowest level whose span covers the delta.  All
        dues must be > self.tick (the arm clamp)."""
        delta = dues - self.tick
        rem = np.ones(len(slots), bool)
        for l in range(len(self.bits)):
            sel = rem & (delta < self.spans[l])
            if not sel.any():
                continue
            rem &= ~sel
            b = (dues[sel] >> self.shifts[l]) & self.masks[l]
            s_sel, st_sel = slots[sel], stamps[sel]
            if len(b) == 1:
                self.levels[l][int(b[0])].append((s_sel, st_sel))
            else:
                order = np.argsort(b, kind="stable")
                b_s, s_s, st_s = b[order], s_sel[order], st_sel[order]
                _, starts = np.unique(b_s, return_index=True)
                bounds = np.append(starts, len(b_s))
                for i in range(len(bounds) - 1):
                    self.levels[l][int(b_s[bounds[i]])].append(
                        (s_s[bounds[i]:bounds[i + 1]],
                         st_s[bounds[i]:bounds[i + 1]]))
            if not rem.any():
                return
        if rem.any():
            self.overflow.append((slots[rem], stamps[rem]))

    def advance(self, t: int) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Step the wheel to tick ``t``, cascading higher levels down at
        their boundaries and collecting every due bucket's chunks (stale
        stamps included: the caller filters)."""
        out: List[Tuple[np.ndarray, np.ndarray]] = []
        top = len(self.bits) - 1
        while self.tick < t:
            self.tick += 1
            T = self.tick
            for l in range(top, 0, -1):
                if T & ((1 << self.shifts[l]) - 1):
                    continue
                b = (T >> self.shifts[l]) & self.masks[l]
                chunks = self.levels[l][b]
                if chunks:
                    self.levels[l][b] = []
                    for s, st in chunks:
                        self._redistribute(s, st, out)
                if l == top and self.overflow:
                    ov, self.overflow = self.overflow, []
                    for s, st in ov:
                        self._redistribute(s, st, out)
            b0 = T & self.masks[0]
            if self.levels[0][b0]:
                out.extend(self.levels[0][b0])
                self.levels[0][b0] = []
        return out

    def _redistribute(self, slots, stamps, out) -> None:
        ok = self.stamp_ok(slots, stamps)
        if not ok.all():
            slots, stamps = slots[ok], stamps[ok]
        if not len(slots):
            return
        dues = self.due_of(slots)
        now = dues <= self.tick
        if now.any():
            out.append((slots[now], stamps[now]))
            keep = ~now
            slots, stamps, dues = slots[keep], stamps[keep], dues[keep]
        if len(slots):
            self.place(slots, stamps, dues)

    def entries(self) -> int:
        n = 0
        for level in self.levels:
            for bucket in level:
                n += sum(len(s) for s, _ in bucket)
        n += sum(len(s) for s, _ in self.overflow)
        return n


class _TypeTimers:
    """One vector type's slot columns: int32 device tensors (the harvest
    reads these), host mirrors (bookkeeping and metrics read these, with
    no device→host copy), the (key, name_id) → slot index and the wheel.
    Slot 0 is the permanently dead slot every pad targets."""

    __slots__ = ("device", "cap", "key", "due", "name", "period",
                 "key_np", "due_np", "name_np", "period_np", "stamp_np",
                 "index", "free", "wheel")

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.cap = 0
        self.key = self.due = self.name = self.period = None
        self.key_np = np.empty(0, np.int64)
        self.due_np = np.empty(0, np.int64)
        self.name_np = np.empty(0, np.int32)
        self.period_np = np.empty(0, np.int64)
        self.stamp_np = np.empty(0, np.int64)
        self.index: Dict[Tuple[int, int], int] = {}
        self.free: List[int] = []
        self.wheel: Optional[_Wheel] = None

    @property
    def armed(self) -> int:
        return len(self.index)

    def grow(self, need: int) -> None:
        new_cap = max(1024, self.cap)
        while new_cap - self.armed < need:
            new_cap *= 2
        if new_cap == self.cap:
            return
        old = self.cap
        size = new_cap + 1

        def ext(a, fill, dtype):
            out = np.full(size, fill, dtype)
            out[:len(a)] = a
            return out

        self.key_np = ext(self.key_np, _SENT, np.int64)
        self.due_np = ext(self.due_np, 0, np.int64)
        self.name_np = ext(self.name_np, 0, np.int32)
        self.period_np = ext(self.period_np, 0, np.int64)
        self.stamp_np = ext(self.stamp_np, 0, np.int64)
        self.key_np[0] = _SENT  # the dead slot
        self.free.extend(range(old + 1, new_cap + 1))
        self.cap = new_cap
        self.sync_device()

    def sync_device(self) -> None:
        """Rebuild the device columns from the host mirrors (growth),
        clipped into int32 as the JAX plane clips them.  Steady-state
        arms and harvests write in place."""
        dev = self.device
        self.key = host_upload(
            np.clip(self.key_np, 0, _SENT).astype(np.int32), dev)
        self.due = host_upload(
            np.clip(self.due_np, -2**31 + 1, 2**31 - 1).astype(np.int32),
            dev)
        self.name = host_upload(self.name_np.astype(np.int32), dev)
        self.period = host_upload(
            np.clip(self.period_np, 0, 2**31 - 1).astype(np.int32), dev)


class TimersPlane:
    """The engine-attached timers plane.  Every entry point is host-
    synchronous and runs between ticks; ``advance_to`` is the run_tick
    hook.  Ticks are the time base."""

    def __init__(self, engine) -> None:
        self._engine = weakref.ref(engine)
        self._types: Dict[str, _TypeTimers] = {}
        self._names: List[str] = []
        self._name_ids: Dict[str, int] = {}
        # the delta op log since the last checkpoint cut: (op, type, keys,
        # name ids, dues, periods) chunks, rows bounded by
        # config.timers_ops_cap — overflow promotes the next delta export
        # to a full
        self._ops: List[Tuple] = []
        self._ops_rows = 0
        self._ops_overflow = False
        # ops recorded before a store was attached are incomplete: the
        # first export after attach must be a full
        self._ops_incomplete = True
        self.fired_total = 0
        self.re_armed_total = 0
        self.cancelled_total = 0
        # timers moved out and in by cross-silo handoffs
        self.exported_total = 0
        self.adopted_total = 0
        self.harvests = 0
        self.harvest_seconds = 0.0
        self.last_harvest_width = 0
        self.worst_lateness_ticks = 0

    # -- plumbing -----------------------------------------------------------

    def engine(self):
        return self._engine()

    @property
    def armed_total(self) -> int:
        return sum(tt.armed for tt in self._types.values())

    def _intern(self, name: str) -> int:
        nid = self._name_ids.get(name)
        if nid is None:
            nid = len(self._names)
            self._name_ids[name] = nid
            self._names.append(name)
        return nid

    def _bits(self) -> Tuple[int, ...]:
        return tuple(self.engine().config.timers_wheel_bits)

    def _type(self, type_name: str) -> _TypeTimers:
        tt = self._types.get(type_name)
        if tt is None:
            eng = self.engine()
            info = eng.arena_for(type_name).info
            if METHOD not in info.handlers:
                raise ValueError(
                    f"{type_name} has no {METHOD} handler — a device "
                    f"timer needs one to deliver into")
            tt = self._types[type_name] = _TypeTimers(eng.device)
        return tt

    def _wheel_for(self, tt: _TypeTimers) -> _Wheel:
        if tt.wheel is None or tt.armed == 0:
            # (re)anchor an empty wheel at the current tick: a wheel that
            # idled at 0 armed must not walk a catch-up
            tt.wheel = _Wheel(self._bits(), self.engine().tick_number,
                              due_of=lambda s: tt.due_np[s],
                              stamp_ok=lambda s, st: tt.stamp_np[s] == st)
        return tt.wheel

    # -- arm / cancel -------------------------------------------------------

    def arm(self, type_name: str, key: int, name: str, due_tick: int,
            period_ticks: int = 0) -> None:
        """Arm one timer: fires ``{"reminder_id": <interned name>}`` at
        ``receive_reminder`` on grain ``key`` at ``due_tick`` (clamped to
        at least the next tick), re-armed every ``period_ticks``
        thereafter (0 = one-shot)."""
        self.arm_batch(type_name, np.asarray([key], np.int64),
                       np.asarray([due_tick], np.int64),
                       np.asarray([period_ticks], np.int64), name)

    def arm_batch(self, type_name: str, keys: np.ndarray,
                  due_ticks: np.ndarray, period_ticks=0,
                  name: str = "reminder") -> int:
        """Vectorized arm: one K14 launch for the whole batch.  A key
        already armed under ``name`` is re-armed (replace).  Keys must fit
        the narrow device representation (< 2**31 - 1)."""
        keys = np.asarray(keys, np.int64)
        if len(keys) == 0:
            return 0
        if keys.min() < 0 or keys.max() >= _SENT:
            raise ValueError("device timers need narrow keys "
                             "(0 <= key < 2**31 - 1)")
        nid = self._intern(name)
        nids = np.full(len(keys), nid, np.int32)
        dues = np.asarray(due_ticks, np.int64)
        periods = np.broadcast_to(
            np.asarray(period_ticks, np.int64), keys.shape).copy()
        self._record(OP_ARM, type_name, keys, nids, dues, periods)
        return self._arm_host(type_name, keys, nids, dues, periods)

    def _arm_host(self, type_name: str, keys, nids, dues, periods,
                  sync: bool = True) -> int:
        """The arm core: host mirrors, wheel, then one K14 write
        (``sync=False`` defers the device write to ``sync_device``: a
        restore arms many batches, then uploads once)."""
        eng = self.engine()
        tt = self._type(type_name)
        n = len(keys)
        # every armed due is strictly in the future
        dues = np.maximum(dues, eng.tick_number + 1)
        if len(tt.free) < n:
            tt.grow(n)
        wheel = self._wheel_for(tt)
        if n == 1:
            slots = np.asarray([tt.free.pop()], np.int64)
        else:
            slots = np.asarray(tt.free[-n:], np.int64)
            del tt.free[-n:]
        index = tt.index
        freed: List[int] = []
        # host lists: a numpy scalar per element costs several times more
        for k, slot in zip(zip(np.asarray(keys).tolist(),
                               np.asarray(nids).tolist()), slots.tolist()):
            old = index.get(k)
            if old is not None:
                freed.append(old)  # re-arm = replace
            index[k] = slot
        if freed:
            fr = np.asarray(freed, np.int64)
            tt.key_np[fr] = _SENT
            tt.stamp_np[fr] += 1
            tt.free.extend(freed)
        tt.key_np[slots] = keys
        tt.due_np[slots] = dues
        tt.name_np[slots] = nids
        tt.period_np[slots] = periods
        tt.stamp_np[slots] += 1
        wheel.place(slots, tt.stamp_np[slots], dues)
        if sync:
            self._write_slots(tt, slots)
        return n

    def _write_slots(self, tt: _TypeTimers, slots: np.ndarray) -> None:
        """One K14 launch writing ``slots``' host mirrors into the device
        columns: the slot index and the four values ride one pinned
        [5, m] upload, pow2-padded to the dead slot 0 with the sentinel
        values."""
        idx = pow2_pad(slots.astype(np.int32), 0)
        m = idx.shape[0]
        packed = np.stack([
            idx,
            _pad_vals(np.clip(tt.key_np[slots], 0, _SENT), m, _SENT,
                      np.int32),
            _pad_vals(np.clip(tt.due_np[slots], -2**31 + 1, 2**31 - 1),
                      m, 0, np.int32),
            _pad_vals(tt.name_np[slots], m, 0, np.int32),
            _pad_vals(np.clip(tt.period_np[slots], 0, 2**31 - 1), m, 0,
                      np.int32)])
        dev = host_upload(packed, tt.device)
        timers_write(tt.key, tt.due, tt.name, tt.period, *dev.unbind(0))

    def cancel(self, type_name: str, key: int, name: str) -> bool:
        """Disarm (key, name).  O(1): the wheel's bucket entry dies lazily
        at harvest through the stamp bump."""
        nid = self._name_ids.get(name)
        tt = self._types.get(type_name)
        if nid is None or tt is None:
            return False
        slot = tt.index.pop((int(key), nid), None)
        if slot is None:
            return False
        self._record(OP_CANCEL, type_name, np.asarray([key], np.int64),
                     np.asarray([nid], np.int32), np.zeros(1, np.int64),
                     np.zeros(1, np.int64))
        self._free_slots(tt, np.asarray([slot], np.int64), sync=True)
        self.cancelled_total += 1
        return True

    def _free_slots(self, tt: _TypeTimers, slots: np.ndarray,
                    sync: bool) -> None:
        tt.key_np[slots] = _SENT
        tt.stamp_np[slots] += 1
        tt.free.extend(slots.tolist())
        if sync:
            self._write_slots(tt, slots)

    def armed_for(self, type_name: str, key: int
                  ) -> List[Tuple[str, int, int]]:
        """(name, due_tick, period_ticks) of every timer armed on ``key``
        (host-mirror scan)."""
        tt = self._types.get(type_name)
        if tt is None:
            return []
        out = []
        for (k, nid), slot in tt.index.items():
            if k == int(key):
                out.append((self._names[nid], int(tt.due_np[slot]),
                            int(tt.period_np[slot])))
        return sorted(out)

    # -- the per-tick harvest -----------------------------------------------

    def advance_to(self, t: int) -> float:
        """The run_tick hook: advance every type's wheel to tick ``t``,
        harvest the due buckets, launch K15 once per type with due slots
        and queue the fired batches.  Returns the elapsed host seconds
        (0.0 when nothing is armed)."""
        if not self._types:
            return 0.0
        t0 = time.perf_counter()
        any_work = False
        for type_name, tt in self._types.items():
            if tt.armed == 0:
                if tt.wheel is not None:
                    tt.wheel.tick = t
                continue
            any_work = True
            self._advance_type(type_name, tt, t)
        if not any_work:
            return 0.0
        dt = time.perf_counter() - t0
        self.harvest_seconds += dt
        return dt

    def _advance_type(self, type_name: str, tt: _TypeTimers,
                      t: int) -> None:
        from orleans_tpu_torch.tensor.engine import PendingBatch

        eng = self.engine()
        wheel = self._wheel_for(tt)
        jump = t - wheel.tick
        if jump <= 0:
            return
        if jump > eng.config.timers_catchup_jump:
            # a long idle or fused stretch: rebuilding from the live
            # mirrors is O(armed), cheaper than stepping every tick
            chunks = [self._rebuild(tt, t)]
        else:
            chunks = wheel.advance(t)
        if not chunks:
            return
        if len(chunks) == 1:
            slots, stamps = chunks[0]
        else:
            slots = np.concatenate([c[0] for c in chunks])
            stamps = np.concatenate([c[1] for c in chunks])
        if not len(slots):
            return
        ok = (tt.stamp_np[slots] == stamps) & (tt.key_np[slots] != _SENT)
        slots = slots[ok]
        if not len(slots):
            return
        dues = tt.due_np[slots]
        later = dues > t
        if later.any():
            # re-place anything not yet due (clamped cascades)
            lat = slots[later]
            wheel.place(lat, tt.stamp_np[lat], tt.due_np[lat])
            slots, dues = slots[~later], dues[~later]
        if not len(slots):
            return
        # -- the ONE device pass for this type (K15) ------------------------
        idx = host_upload(pow2_pad(slots.astype(np.int32), 0), tt.device)
        k, nm, fired = timers_harvest(tt.key, tt.due, tt.period, tt.name,
                                      idx, t)
        eng.queues[(type_name, METHOD)].append(PendingBatch(
            args={"reminder_id": nm}, keys_dev=k, mask=fired,
            inject_tick=eng.tick_number))
        # -- host mirrors + metrics (the kernel's deterministic twin) -------
        periods = tt.period_np[slots]
        rearm = periods > 0
        oneshot = slots[~rearm]
        if len(oneshot):
            index = tt.index
            for k in zip(tt.key_np[oneshot].tolist(),
                         tt.name_np[oneshot].tolist()):
                index.pop(k, None)
            self._free_slots(tt, oneshot, sync=False)  # K15 wrote them
        rearm_slots = slots[rearm]
        if len(rearm_slots):
            d, p = dues[rearm], periods[rearm]
            tt.due_np[rearm_slots] = d + ((t - d) // p + 1) * p
            tt.stamp_np[rearm_slots] += 1
            wheel.place(rearm_slots, tt.stamp_np[rearm_slots],
                        tt.due_np[rearm_slots])
            self.re_armed_total += len(rearm_slots)
        self.fired_total += len(slots)
        self.harvests += 1
        self.last_harvest_width = len(slots)
        late = int((t - dues).max()) if len(dues) else 0
        if late > self.worst_lateness_ticks:
            self.worst_lateness_ticks = late

    def _rebuild(self, tt: _TypeTimers, t: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        live = np.flatnonzero(tt.key_np != _SENT)
        dues = tt.due_np[live]
        fire = live[dues <= t]
        tt.wheel = _Wheel(self._bits(), t,
                          due_of=lambda s: tt.due_np[s],
                          stamp_ok=lambda s, st: tt.stamp_np[s] == st)
        later = live[dues > t]
        if len(later):
            tt.wheel.place(later, tt.stamp_np[later], tt.due_np[later])
        return fire, tt.stamp_np[fire]

    # -- migration (router ride-along) --------------------------------------

    def export_keys(self, type_name: str, keys: np.ndarray
                    ) -> Optional[Dict[str, Any]]:
        """Detach every timer armed on the moving keys and return them as
        a transport-plain payload (remaining ticks are relative: the
        source and target engine clocks differ).  Runs inside the
        handoff's synchronous block: the source can no longer fire them,
        the target arms them before traffic resumes."""
        tt = self._types.get(type_name)
        if tt is None or tt.armed == 0:
            return None
        moving = np.isin(tt.key_np, np.asarray(keys, np.int64))
        moving[0] = False
        slots = np.flatnonzero(moving)
        if not len(slots):
            return None
        eng = self.engine()
        payload = {
            "keys": tt.key_np[slots].tolist(),
            "names": [self._names[i] for i in tt.name_np[slots]],
            "remaining": np.maximum(
                tt.due_np[slots] - eng.tick_number, 0).tolist(),
            "periods": tt.period_np[slots].tolist(),
        }
        for s in slots:
            tt.index.pop((int(tt.key_np[s]), int(tt.name_np[s])), None)
        self._record(OP_CANCEL, type_name, tt.key_np[slots],
                     tt.name_np[slots], np.zeros(len(slots), np.int64),
                     np.zeros(len(slots), np.int64))
        self._free_slots(tt, slots, sync=True)
        self.exported_total += len(slots)
        return payload

    def adopt_keys(self, type_name: str, payload: Dict[str, Any]) -> int:
        """Arm migrated timers at the local clock: due = local tick +
        remaining (at least one tick out)."""
        if not payload or not payload.get("keys"):
            return 0
        eng = self.engine()
        keys = np.asarray(payload["keys"], np.int64)
        nids = np.asarray([self._intern(n) for n in payload["names"]],
                          np.int32)
        dues = eng.tick_number + np.maximum(
            np.asarray(payload["remaining"], np.int64), 1)
        periods = np.asarray(payload["periods"], np.int64)
        self._record(OP_ARM, type_name, keys, nids, dues, periods)
        n = self._arm_host(type_name, keys, nids, dues, periods, sync=True)
        self.adopted_total += n
        return n

    # -- durability (checkpoint ride-along) ---------------------------------

    def _record(self, op: int, type_name: str, keys, nids, dues,
                periods) -> None:
        eng = self.engine()
        if not eng.checkpointer.enabled or eng.checkpointer._replaying:
            self._ops_incomplete = True
            return
        self._ops.append((op, type_name, np.asarray(keys, np.int64),
                          np.asarray(nids, np.int32),
                          np.asarray(dues, np.int64),
                          np.asarray(periods, np.int64)))
        self._ops_rows += len(keys)
        if self._ops_rows > eng.config.timers_ops_cap:
            self._ops_overflow = True

    def export_cut(self, kind: str
                   ) -> Optional[Tuple[Dict[str, np.ndarray],
                                       Dict[str, Any]]]:
        """Export for the checkpoint cut being pinned: full = the compact
        live slots with absolute dues (every armed due lies after the cut,
        so adoption needs no catch-up), delta = the op log since the last
        cut.  Returns (arrays, meta) for one store blob, or None when
        there is nothing to persist."""
        tick = self.engine().tick_number
        if kind != "full" and (self._ops_overflow or self._ops_incomplete):
            kind = "full"  # the op log is incomplete or overflowed
        if kind != "full":
            ops, self._ops = self._ops, []
            self._ops_rows = 0
            if not ops:
                return None
            types = sorted({t for _, t, *_ in ops})
            tix = {t: i for i, t in enumerate(types)}
            arrays = {
                "op": np.concatenate(
                    [np.full(len(o[2]), o[0], np.int8) for o in ops]),
                "type": np.concatenate(
                    [np.full(len(o[2]), tix[o[1]], np.int32) for o in ops]),
                "key": np.concatenate([o[2] for o in ops]),
                "name": np.concatenate([o[3] for o in ops]),
                "due": np.concatenate([o[4] for o in ops]),
                "period": np.concatenate([o[5] for o in ops]),
            }
            return arrays, {"kind": "delta", "tick": tick, "types": types,
                            "names": list(self._names)}
        self._ops = []
        self._ops_rows = 0
        self._ops_overflow = False
        self._ops_incomplete = False
        arrays = {}
        types = []
        for type_name, tt in sorted(self._types.items()):
            if tt.armed == 0:
                continue
            live = np.flatnonzero(tt.key_np != _SENT)
            i = len(types)
            types.append(type_name)
            arrays[f"{i}:keys"] = tt.key_np[live]
            arrays[f"{i}:dues"] = tt.due_np[live]
            arrays[f"{i}:names"] = tt.name_np[live]
            arrays[f"{i}:periods"] = tt.period_np[live]
        if not types:
            return None
        return arrays, {"kind": "full", "tick": tick, "types": types,
                        "names": list(self._names)}

    def restore_entry(self, arrays: Dict[str, np.ndarray],
                      meta: Dict[str, Any]) -> None:
        """Apply one recovered cut to the host mirrors (the device upload
        and the wheel rebuild happen once, in ``finish_restore``)."""
        remap = np.asarray([self._intern(n) for n in meta["names"]],
                           np.int32) if meta["names"] \
            else np.empty(0, np.int32)
        if meta["kind"] == "full":
            self._types.clear()
            for i, type_name in enumerate(meta["types"]):
                keys = np.asarray(arrays[f"{i}:keys"], np.int64)
                self._arm_host(
                    type_name, keys,
                    remap[np.asarray(arrays[f"{i}:names"], np.int64)],
                    np.asarray(arrays[f"{i}:dues"], np.int64),
                    np.asarray(arrays[f"{i}:periods"], np.int64),
                    sync=False)
            return
        ops = np.asarray(arrays["op"])
        op_type = np.asarray(arrays["type"])
        keys = np.asarray(arrays["key"], np.int64)
        names = remap[np.asarray(arrays["name"], np.int64)] if len(keys) \
            else np.empty(0, np.int32)
        dues = np.asarray(arrays["due"], np.int64)
        periods = np.asarray(arrays["period"], np.int64)
        # replay runs of one (op, type) in their original order
        i = 0
        while i < len(ops):
            j = i
            while j < len(ops) and ops[j] == ops[i] \
                    and op_type[j] == op_type[i]:
                j += 1
            type_name = meta["types"][int(op_type[i])]
            if ops[i] == OP_ARM:
                self._arm_host(type_name, keys[i:j], names[i:j],
                               dues[i:j], periods[i:j], sync=False)
            else:
                tt = self._types.get(type_name)
                if tt is not None:
                    freed = [s for s in (
                        tt.index.pop((int(k), int(n)), None)
                        for k, n in zip(keys[i:j], names[i:j]))
                        if s is not None]
                    if freed:
                        self._free_slots(
                            tt, np.asarray(freed, np.int64), sync=False)
            i = j

    def finish_restore(self, cut_tick: int) -> None:
        """The silent catch-up: a slot due at or before the cut had its
        fire acknowledged before the cut (its effects are in the recovered
        state or replay from the journal) — periodic timers advance their
        phase past the cut without firing, one-shots retire.  Then each
        wheel rebuilds at the cut tick and the columns upload once."""
        for tt in self._types.values():
            live = np.flatnonzero(tt.key_np != _SENT)
            dues = tt.due_np[live]
            stale = live[dues <= cut_tick]
            if len(stale):
                p = tt.period_np[stale]
                periodic = p > 0
                adv = stale[periodic]
                if len(adv):
                    d, pp = tt.due_np[adv], p[periodic]
                    tt.due_np[adv] = d + ((cut_tick - d) // pp + 1) * pp
                dead = stale[~periodic]
                if len(dead):
                    for s in dead:
                        tt.index.pop(
                            (int(tt.key_np[s]), int(tt.name_np[s])), None)
                    self._free_slots(tt, dead, sync=False)
            self._rebuild(tt, cut_tick)
            tt.sync_device()
        # the restored state is the baseline the next cut deltas from
        self._ops = []
        self._ops_rows = 0
        self._ops_overflow = False
        self._ops_incomplete = False

    # -- observability ------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        return {
            "armed": self.armed_total,
            "fired": self.fired_total,
            "re_armed": self.re_armed_total,
            "cancelled": self.cancelled_total,
            "exported": self.exported_total,
            "adopted": self.adopted_total,
            "harvests": self.harvests,
            "mean_harvest_width": round(
                self.fired_total / self.harvests, 3) if self.harvests
            else 0.0,
            "last_harvest_width": self.last_harvest_width,
            "worst_lateness_ticks": self.worst_lateness_ticks,
            "harvest_seconds": round(self.harvest_seconds, 6),
            "types": {t: tt.armed for t, tt in self._types.items()
                      if tt.armed},
        }
