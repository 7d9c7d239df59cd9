"""GPSTracker sample — movement-gated notifications, on the port.

The torch twin of ``samples/gpstracker.py`` (reference: Samples/GPSTracker
— DeviceGrain.cs:37 ProcessMessage, its change check :44 and GetSpeed
:64; PushNotifierGrain.cs:39, a [StatelessWorker] that batches messages
and flushes on a timer).  Every device is a row; a tick's position fixes
arrive as one batch, the change gate and the equirectangular speed are
elementwise, and the forward to the notifier is an ``Emit`` whose mask is
the gate, so unmoved devices send nothing.  The notifier tier is
``N_NOTIFIERS`` rows addressed by ``device % N_NOTIFIERS`` (the
stateless-worker pool); its per-row fan-in is the batching the reference
does with a timer.

Kernels on the path: the previous fix is read with K13 (pad lanes read
row 0, as JAX's clamped gather does), the new fix written with K3 SET,
``moves`` and the notifier's sums taken with K4, the notifier keys
resolved with K1.  ``cos`` and ``sqrt`` may differ from XLA's by an ulp,
so ``speed`` agrees with the JAX package within a few float32 ulps, not
bit for bit; the gate and every count are exact.
"""

from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np
import torch

from orleans_tpu_torch.core.grain import batched_method
from orleans_tpu_torch.kernels.lifecycle import gather_rows
from orleans_tpu_torch.tensor.vector_grain import (
    Batch,
    Emit,
    VectorGrain,
    field,
    scatter_rows,
    seg_sum,
    vector_grain,
)

EARTH_R = 6371.0 * 1000.0  # meters (reference: DeviceGrain.cs:70)
N_NOTIFIERS = 8            # notifier pool width (stateless-worker analog)


@vector_grain
class DeviceGrain(VectorGrain):
    """Per-device last-fix state (reference: DeviceGrain.cs:37)."""

    lat = field(torch.float32, 0.0)
    lon = field(torch.float32, 0.0)
    ts = field(torch.float32, -1.0)         # -1 = no fix yet
    speed = field(torch.float32, 0.0)
    moves = field(torch.int32, 0)           # fixes that changed position

    @batched_method
    @staticmethod
    def process_message(state, batch: Batch, n_rows: int):
        rows, args = batch.rows, batch.args
        lat = args["lat"].to(torch.float32)
        lon = args["lon"].to(torch.float32)
        ts = args["ts"].to(torch.float32)
        dev = args["device"].to(torch.int32)

        prev_lat = gather_rows(state["lat"], rows)
        prev_lon = gather_rows(state["lon"], rows)
        prev_ts = gather_rows(state["ts"], rows)
        first = prev_ts < 0.0
        moved = (first | (prev_lat != lat) | (prev_lon != lon)) & batch.mask

        # equirectangular speed (reference: GetSpeed, DeviceGrain.cs:64)
        x = (lon - prev_lon) * torch.cos(torch.deg2rad((lat + prev_lat)
                                                       * 0.5))
        y = lat - prev_lat
        dist = torch.sqrt(x * x + y * y) * math.radians(1.0) * EARTH_R
        dt = ts - prev_ts
        speed = torch.where(first | (dt <= 0.0), 0.0,
                            dist / torch.clamp(dt, min=1e-6))

        state = {
            **state,
            "lat": scatter_rows(state["lat"], rows, lat),
            "lon": scatter_rows(state["lon"], rows, lon),
            "ts": scatter_rows(state["ts"], rows, ts),
            "speed": scatter_rows(state["speed"], rows, speed),
            "moves": state["moves"] + seg_sum(moved.to(torch.int32), rows,
                                              n_rows),
        }
        emit = Emit(
            interface="PushNotifierGrain", method="send_message",
            keys=dev % N_NOTIFIERS,
            args={"speed": speed, "one": moved.to(torch.int32)},
            mask=moved)
        return state, None, (emit,)


@vector_grain
class PushNotifierGrain(VectorGrain):
    """Notification batcher tier (reference: PushNotifierGrain.cs:39 — a
    tick is the batch window, so the queue is the per-row fan-in)."""

    forwarded = field(torch.int32, 0)       # velocity messages absorbed
    batches = field(torch.int32, 0)         # ticks this row saw traffic
    speed_sum = field(torch.float32, 0.0)

    @batched_method
    @staticmethod
    def send_message(state, batch: Batch, n_rows: int):
        rows, args = batch.rows, batch.args
        count = seg_sum(args["one"].to(torch.int32), rows, n_rows)
        return {
            **state,
            "forwarded": state["forwarded"] + count,
            "batches": state["batches"] + (count > 0).to(torch.int32),
            "speed_sum": state["speed_sum"]
            + seg_sum(args["speed"].to(torch.float32), rows, n_rows),
        }


def _forwarded_total(engine) -> int:
    arena = engine.arena_for("PushNotifierGrain")
    if not arena.live_count:
        return 0
    return int(arena.state["forwarded"].sum())


async def run_gps_load(engine, n_devices: int = 100_000, n_ticks: int = 10,
                       move_fraction: float = 0.7,
                       seed: int = 0) -> Dict[str, float]:
    """Each tick every device reports a fix; ``move_fraction`` of them
    moved (the reference's FakeDeviceGateway).  Unmoved fixes update state
    but emit nothing.  The same draws as the JAX loader."""
    rng = np.random.default_rng(seed)
    devices = np.arange(n_devices, dtype=np.int64)
    engine.arena_for("DeviceGrain").reserve(n_devices)
    engine.arena_for("PushNotifierGrain").reserve(N_NOTIFIERS)
    injector = engine.make_injector("DeviceGrain", "process_message",
                                    devices)
    dev = engine.device

    lat = 47.6 + rng.random(n_devices, dtype=np.float32) * 0.1
    lon = torch.from_numpy(
        -122.1 + rng.random(n_devices, dtype=np.float32) * 0.1).to(dev)
    dev_i32 = torch.from_numpy(devices.astype(np.int32)).to(dev)

    # notification count = the measured notifier delta, whether the
    # engine is cold (first fixes all notify) or warm
    forwarded_before = _forwarded_total(engine)
    ts_base = float(engine.tick_number)  # timestamps monotone on re-runs

    t0 = time.perf_counter()
    for t in range(n_ticks):
        moving = rng.random(n_devices) < move_fraction
        lat = lat + np.where(moving, 1e-4, 0.0).astype(np.float32)
        injector.inject({
            "lat": torch.from_numpy(lat).to(dev), "lon": lon,
            "ts": torch.full((n_devices,), ts_base + t + 1,
                             dtype=torch.float32, device=dev),
            "device": dev_i32,
        })
        await engine.drain_queues()
    await engine.flush()
    engine.wait_completion()
    elapsed = time.perf_counter() - t0

    moved_total = _forwarded_total(engine) - forwarded_before
    messages = n_devices * n_ticks + moved_total
    return {
        "devices": n_devices,
        "ticks": n_ticks,
        "seconds": elapsed,
        "messages": messages,
        "messages_per_sec": messages / elapsed,
        "notified": moved_total,
    }


def gps_windows(n_devices: int, n_windows: int, window: int,
                move_fraction: float, seed: int):
    """The fused loader's inputs: ``(lon [m], [{"lat": [T, m], "ts": [T,
    m]}] per window)`` as numpy, the warm window first — the JAX loader's
    draws, a position cursor carried across windows."""
    rng = np.random.default_rng(seed)
    lat_cursor = 47.6 + rng.random(n_devices, dtype=np.float32) * 0.1
    lon = -122.1 + rng.random(n_devices, dtype=np.float32) * 0.1
    w_rng = np.random.default_rng(seed + 1)
    out = []
    for base in range(n_windows):
        lats = np.empty((window, n_devices), np.float32)
        for t in range(window):
            moving = w_rng.random(n_devices) < move_fraction
            lat_cursor = lat_cursor + np.where(moving, 1e-4,
                                               0.0).astype(np.float32)
            lats[t] = lat_cursor
        ts = (np.arange(window, dtype=np.float32)[:, None]
              + np.float32(base * window + 1))
        out.append({"lat": lats,
                    "ts": np.ascontiguousarray(
                        np.broadcast_to(ts, (window, n_devices)))})
    return lon, out


async def run_gps_load_fused(engine, n_devices: int = 100_000,
                             n_ticks: int = 10, move_fraction: float = 0.7,
                             window: int = 10, seed: int = 0,
                             measure_latency: bool = False
                             ) -> Dict[str, float]:
    """GPS through a fused program: the per-fix step, the movement gate
    (the emit mask) and the notifier fan-in of each window of ticks run as
    one program (on the card one CUDA graph replay).  ``lat`` and ``ts``
    vary per tick and ride as ``[T, m]`` leaves; ``lon`` and the device
    ids are static.  One untimed warm window first."""
    from orleans_tpu_torch.tensor.fused import plan_windows

    devices = np.arange(n_devices, dtype=np.int64)
    engine.arena_for("DeviceGrain").reserve(n_devices)
    engine.arena_for("PushNotifierGrain").reserve(N_NOTIFIERS)
    engine.arena_for("PushNotifierGrain").resolve_rows(
        np.arange(N_NOTIFIERS, dtype=np.int64))
    prog = engine.fuse_ticks("DeviceGrain", "process_message", devices)
    if measure_latency:
        window = 1
    window, n_windows, n_ticks = plan_windows(window, n_ticks)
    dev = engine.device

    lon, host_windows = gps_windows(n_devices, n_windows + 1, window,
                                    move_fraction, seed)
    static = {"lon": torch.from_numpy(lon).to(dev),
              "device": torch.from_numpy(devices.astype(np.int32)).to(dev)}
    windows = [{k: torch.from_numpy(v).to(dev) for k, v in w.items()}
               for w in host_windows]

    prog.run(windows[0], static_args=static)  # untimed warm window
    engine.wait_completion()
    forwarded_before = _forwarded_total(engine)

    tick_durations = []
    t0 = time.perf_counter()
    for stacked in windows[1:]:
        w0 = time.perf_counter()
        prog.run(stacked, static_args=static)
        if measure_latency:
            engine.wait_completion()
            tick_durations.append(time.perf_counter() - w0)
    engine.wait_completion()
    elapsed = time.perf_counter() - t0
    misses = prog.verify()
    if misses:  # not assert: -O must not skip the exactness check
        raise RuntimeError(
            f"fused GPS window touched {misses} unactivated grains")

    forwarded = _forwarded_total(engine)
    # as run_gps_load: fixes injected + notifications delivered, over the
    # timed windows only
    messages = n_devices * n_ticks + (forwarded - forwarded_before)
    stats: Dict[str, float] = {
        "devices": n_devices, "ticks": n_ticks, "seconds": elapsed,
        "messages": messages,
        "messages_per_sec": messages / elapsed,
        "forwarded_total": forwarded,
        "engine": "fused",
    }
    if tick_durations:
        d = np.asarray(tick_durations)
        stats["tick_p50_seconds"] = float(np.percentile(d, 50))
        stats["tick_p99_seconds"] = float(np.percentile(d, 99))
    return stats
