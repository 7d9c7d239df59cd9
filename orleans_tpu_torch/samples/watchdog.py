"""IoT heartbeat-watchdog sample — periodic device-side deadlines from
the timers plane (``tensor/timers_plane.py``), on the port.

The torch twin of ``samples/watchdog.py``: every fleet device grain arms
one PERIODIC "watch" timer at provisioning; heartbeats stream in as
batched vector calls and set a liveness bit; each watch firing (re-armed
inside the same K15 harvest, phase-preserving) checks and clears that
bit, and a device that missed every heartbeat of the window is flagged
dead (reference shape: Orleans IoT samples using IRemindable liveness
deadlines).

Exactness oracle: watch firings are deterministic in tick time (start +
k * period), so the host replays the schedule — per-device ``checks``
equals the number of elapsed windows, devices silent for at least one
full window are flagged exactly at the first watch after the silence,
and devices that never miss end alive with ``deaths == 0``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from orleans_tpu_torch.core.grain import batched_method
from orleans_tpu_torch.kernels.scatter import row_scatter
from orleans_tpu_torch.tensor.vector_grain import (
    Batch,
    VectorGrain,
    field,
    gather_fill,
    scatter_add_rows,
    scatter_rows,
    vector_grain,
)


@vector_grain
class FleetDeviceGrain(VectorGrain):
    """One IoT device: heartbeats race a periodic watchdog deadline."""

    beats = field(torch.int32, 0)
    seen = field(torch.int32, 0)      # heartbeat since the last watch?
    alive = field(torch.int32, 1)
    checks = field(torch.int32, 0)    # watch firings (oracle: k windows)
    deaths = field(torch.int32, 0)    # alive→dead transitions

    @batched_method
    @staticmethod
    def heartbeat(state, batch: Batch, n_rows: int):
        rows = batch.rows
        ones = batch.mask.to(torch.int32)
        return {
            **state,
            "beats": scatter_add_rows(state["beats"], rows, ones),
            # max-with-0: masked lanes can't set the bit
            "seen": row_scatter(state["seen"], rows, ones, "max"),
        }

    @batched_method
    @staticmethod
    def receive_reminder(state, batch: Batch, n_rows: int):
        """One batched check-and-clear for every watchdog due this tick:
        dead = no heartbeat seen since the previous firing."""
        rows, mask = batch.rows, batch.mask
        ones = mask.to(torch.int32)
        seen = gather_fill(state["seen"], rows, 1)
        alive = gather_fill(state["alive"], rows, 0)
        died = (mask & (seen == 0) & (alive == 1)).to(torch.int32)
        new_alive = torch.where(mask & (seen == 0), 0, alive)
        # JAX applies alive := min(alive, new_alive) and seen := min(seen,
        # where(mask, 0, seen)); new_alive <= alive and every lane of one
        # row reads the same pre-state, so a SET on the masked lanes
        # writes the same values (K3 has no MIN)
        fired = torch.where(mask, rows, -1)
        return {
            **state,
            "checks": scatter_add_rows(state["checks"], rows, ones),
            "deaths": scatter_add_rows(state["deaths"], rows, died),
            "alive": scatter_rows(state["alive"], fired, new_alive),
            # clear the window bit only where the watch actually fired
            "seen": scatter_rows(state["seen"], fired, 0),
        }


# ---------------------------------------------------------------------------
# load generator + oracle
# ---------------------------------------------------------------------------

async def run_watchdog_load(engine, n_devices: int = 10_000,
                            window: int = 8, n_windows: int = 4,
                            silent_frac: float = 0.25, seed: int = 0,
                            verify: bool = True) -> Dict[str, float]:
    """Provision ``n_devices`` with a periodic watch every ``window``
    ticks; a ``silent_frac`` subset stops heartbeating after the first
    window; run ``n_windows`` full windows and replay the schedule on the
    host.  The same schedule as the JAX sample's, drawn from the same
    seed."""
    rng = np.random.default_rng(seed)
    keys = np.arange(n_devices, dtype=np.int64)
    engine.arena_for("FleetDeviceGrain").reserve(n_devices)

    injector = engine.make_injector("FleetDeviceGrain", "heartbeat", keys)
    injector.inject({})
    engine.run_tick()
    t0 = engine.tick_number

    engine.timers.arm_batch("FleetDeviceGrain", keys,
                            np.full(n_devices, t0 + window, np.int64),
                            window, "watch")
    silent = rng.random(n_devices) < silent_frac
    live_keys = keys[~silent]
    live_inj = engine.make_injector("FleetDeviceGrain", "heartbeat",
                                    live_keys)

    n_ticks = window * n_windows
    for t in range(1, n_ticks + 1):
        if t % 3 == 0:                      # heartbeat cadence < window
            if t <= window:
                injector.inject({})         # everyone beats at first
            else:
                live_inj.inject({})         # the silent set goes dark
        engine.run_tick()
    await engine.flush()

    arena = engine.arena_for("FleetDeviceGrain")
    rows, found = arena.lookup_rows(keys)
    got = {n: c.cpu().numpy()[rows] for n, c in arena.state.items()}
    # host replay: watches fire at t0+window, +2*window, ...; the first
    # window always has beats, later windows only for the live set — so
    # silent devices die at exactly the SECOND firing
    want_checks = n_windows
    want_dead = silent & (n_windows >= 2)
    stats = {
        "devices": n_devices,
        "silent": int(silent.sum()),
        "flagged_dead": int((got["alive"] == 0).sum()),
        "exact": bool(
            found.all()
            and (got["checks"] == want_checks).all()
            and ((got["alive"] == 0) == want_dead).all()
            and (got["deaths"] == want_dead.astype(np.int32)).all()
            and (got["deaths"][~silent] == 0).all()),
    }
    if verify:
        assert stats["exact"], {
            "checks": np.unique(got["checks"]).tolist(),
            "want_checks": want_checks,
            "dead_mismatch": int(
                ((got["alive"] == 0) != want_dead).sum())}
    return stats
