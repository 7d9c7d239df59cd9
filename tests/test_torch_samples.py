"""Differential tests of the port's GPSTracker and TwitterSentiment samples
against the JAX package: twins of tests/test_sample_workloads.py's GPS and
Twitter cases and of tests/test_streams_plane.py's grouped-Twitter case,
at small sizes.  Each scenario runs on a JAX engine and on a port engine
on ``device="cpu"`` (both at their defaults: ledger and attribution plane
on) from the same numpy draws, asserts the JAX test's own properties on
both sides, then compares the two.

* Integer columns (``moves``, the notifier counts, the hashtag sums,
  ``counted``, the counter) must be equal.
* float32 columns computed with ``cos`` and ``sqrt`` (``speed``, the
  notifier's ``speed_sum``) may differ from XLA's by an ulp per step:
  ``speed`` within a relative 1e-5, ``speed_sum`` within ``1e-5 *
  sum|speed|`` per notifier row plus Higham's bound for its summation.
* ``last_score`` on the scatter path is one of the scores its tag
  received in the last tick that touched it (``scatter_rows`` keeps one
  writer of duplicate rows, not a chosen one; JAX promises no order
  either); on the grouped path it is each row's last lane, held exactly
  against a numpy replay.

The installed JAX lacks ``jax.core.trace_state_clean``, which the JAX
attribution plane's flush calls: the ``jax_trace_shim`` fixture sets it
per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import samples.gpstracker as jax_gps
import samples.twitter_sentiment as jax_tw
from orleans_tpu.tensor import TensorEngine as JaxTensorEngine

from orleans_tpu_torch.samples import gpstracker as port_gps
from orleans_tpu_torch.samples import twitter_sentiment as port_tw
from orleans_tpu_torch.tensor import TensorEngine

SPEED_RTOL = 1e-5


@pytest.fixture
def jax_trace_shim(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _engines():
    return JaxTensorEngine(), TensorEngine(device="cpu")


def _col(engine, type_name, name, keys) -> np.ndarray:
    arena = engine.arena_for(type_name)
    rows, found = arena.lookup_rows(np.asarray(keys, dtype=np.int64))
    assert found.all()
    col = arena.state[name]
    col = col.cpu().numpy() if isinstance(col, torch.Tensor) \
        else np.asarray(col)
    return col[rows]


def _assert_notifiers_twin(je, pe):
    keys = np.sort(je.arena_for("PushNotifierGrain").keys())
    np.testing.assert_array_equal(
        np.sort(pe.arena_for("PushNotifierGrain").keys()), keys)
    for name in ("forwarded", "batches"):
        np.testing.assert_array_equal(
            _col(pe, "PushNotifierGrain", name, keys),
            _col(je, "PushNotifierGrain", name, keys), err_msg=name)
    pj = _col(je, "PushNotifierGrain", "speed_sum", keys).astype(np.float64)
    pp = _col(pe, "PushNotifierGrain", "speed_sum", keys).astype(np.float64)
    n = _col(je, "PushNotifierGrain", "forwarded", keys)
    tol = (SPEED_RTOL + 2 * n * 2.0**-24) * np.abs(pj)
    assert np.all(np.abs(pp - pj) <= tol)


def _assert_devices_twin(je, pe, devices):
    np.testing.assert_array_equal(_col(pe, "DeviceGrain", "moves", devices),
                                  _col(je, "DeviceGrain", "moves", devices))
    for name in ("lat", "lon", "ts"):
        np.testing.assert_array_equal(
            _col(pe, "DeviceGrain", name, devices),
            _col(je, "DeviceGrain", name, devices), err_msg=name)
    np.testing.assert_allclose(_col(pe, "DeviceGrain", "speed", devices),
                               _col(je, "DeviceGrain", "speed", devices),
                               rtol=SPEED_RTOL, atol=0)


# -- GPSTracker ---------------------------------------------------------------

def test_gps_movement_gate_and_speed(run, jax_trace_shim):
    """Only moved devices notify; speed matches the equirectangular
    formula (reference: DeviceGrain.GetSpeed); the port equals JAX."""
    devices = np.arange(4, dtype=np.int64)
    lat0 = np.array([47.60, 47.61, 47.62, 47.63], np.float32)
    lon0 = np.full(4, -122.1, np.float32)
    lat1 = lat0 + np.array([1e-3, 0, 1e-3, 0], np.float32)

    async def go(engine, dev):
        engine.arena_for("DeviceGrain").reserve(4)
        engine.arena_for("PushNotifierGrain").reserve(port_gps.N_NOTIFIERS)
        inj = engine.make_injector("DeviceGrain", "process_message",
                                   devices)
        base = {"lon": dev(lon0), "device": dev(devices.astype(np.int32))}
        inj.inject({**base, "lat": dev(lat0),
                    "ts": dev(np.full(4, 1.0, np.float32))})
        await engine.flush()
        inj.inject({**base, "lat": dev(lat1),
                    "ts": dev(np.full(4, 11.0, np.float32))})
        await engine.flush()
        np.testing.assert_array_equal(
            _col(engine, "DeviceGrain", "moves", devices), [2, 1, 2, 1])
        expected = np.deg2rad(1e-3) * 6371000.0 / 10.0
        speed = _col(engine, "DeviceGrain", "speed", devices)
        np.testing.assert_allclose(speed[[0, 2]], expected, rtol=1e-3)
        np.testing.assert_allclose(speed[[1, 3]], 0.0)
        notif = engine.arena_for("PushNotifierGrain").state["forwarded"]
        assert int(notif.sum()) == 4 + 2

    je, pe = _engines()
    run(go(je, jnp.asarray))
    run(go(pe, lambda a: torch.from_numpy(np.array(a))))
    _assert_devices_twin(je, pe, devices)
    _assert_notifiers_twin(je, pe)


def test_gps_load_driver(run, jax_trace_shim):
    je, pe = _engines()
    js = run(jax_gps.run_gps_load(je, n_devices=500, n_ticks=4,
                                  move_fraction=0.5, seed=1))
    ps = run(port_gps.run_gps_load(pe, n_devices=500, n_ticks=4,
                                   move_fraction=0.5, seed=1))
    forwarded = int(pe.arena_for("PushNotifierGrain").state[
        "forwarded"].sum())
    assert forwarded == ps["notified"]
    assert ps["messages"] == 500 * 4 + forwarded
    assert set(ps) == set(js)
    for k in ("devices", "ticks", "messages", "notified"):
        assert ps[k] == js[k], k
    _assert_devices_twin(je, pe, np.arange(500))
    _assert_notifiers_twin(je, pe)
    assert pe.attribution.per_key_totals("DeviceGrain") == \
        je.attribution.per_key_totals("DeviceGrain")


def test_gps_fused_matches_jax_fused_and_unfused(run, jax_trace_shim):
    """The fused loader (windows of 4, one warm window) equals the JAX
    fused loader over the same draws, and the port's unfused replay of
    those draws, row for row."""
    n, window, ticks = 300, 4, 8
    je, pe = _engines()
    js = run(jax_gps.run_gps_load_fused(je, n_devices=n, n_ticks=ticks,
                                        window=window, seed=2))
    ps = run(port_gps.run_gps_load_fused(pe, n_devices=n, n_ticks=ticks,
                                         window=window, seed=2))
    for k in ("devices", "ticks", "messages", "forwarded_total", "engine"):
        assert ps[k] == js[k], k
    devices = np.arange(n)
    _assert_devices_twin(je, pe, devices)
    _assert_notifiers_twin(je, pe)
    # the unfused port over the same per-tick fixes
    ue = TensorEngine(device="cpu")
    lon, windows = port_gps.gps_windows(n, ticks // window + 1, window,
                                        0.7, 2)
    # the notifiers active first, as the fused loader has them (a cold
    # notifier's deliveries would wait for the final drain)
    ue.arena_for("PushNotifierGrain").resolve_rows(
        np.arange(port_gps.N_NOTIFIERS, dtype=np.int64))
    inj = ue.make_injector("DeviceGrain", "process_message", devices)

    async def unfused():
        for w in windows:
            for t in range(window):
                inj.inject({"lat": torch.from_numpy(w["lat"][t].copy()),
                            "ts": torch.from_numpy(w["ts"][t].copy()),
                            "lon": torch.from_numpy(lon),
                            "device": torch.from_numpy(
                                devices.astype(np.int32))})
                await ue.drain_queues()
        await ue.flush()

    run(unfused())
    for name in ("moves", "lat", "ts", "speed"):
        np.testing.assert_array_equal(
            _col(ue, "DeviceGrain", name, devices),
            _col(pe, "DeviceGrain", name, devices), err_msg=name)
    for name in ("forwarded", "batches"):
        np.testing.assert_array_equal(
            _col(ue, "PushNotifierGrain", name, np.arange(8)),
            _col(pe, "PushNotifierGrain", name, np.arange(8)))


# -- TwitterSentiment -----------------------------------------------------------

def _hashtag_cols(engine, tag_keys):
    return {f: _col(engine, "HashtagGrain", f, tag_keys)
            for f in ("total", "positive", "negative", "counted",
                      "last_score")}


def _counter(engine) -> int:
    return int(engine.arena_for("TweetCounterGrain").read_row(
        port_tw.COUNTER_KEY)["hashtags"])


def _last_tick_scores(payloads):
    """tag key → the set of scores it received in the last tick that
    touched it."""
    last = {}
    for keys, scores in payloads:
        tick = {}
        for k, s in zip(keys.tolist(), scores.tolist()):
            tick.setdefault(k, set()).add(s)
        last.update(tick)
    return last


def _assert_hashtags_twin(je, pe, tag_keys, payloads=None):
    """Sums exact against JAX; ``last_score`` in the last tick's set when
    ``payloads`` is given (the scatter path), exact otherwise."""
    jc, pc = _hashtag_cols(je, tag_keys), _hashtag_cols(pe, tag_keys)
    for f in ("total", "positive", "negative", "counted"):
        np.testing.assert_array_equal(pc[f], jc[f], err_msg=f)
    if payloads is None:
        np.testing.assert_array_equal(pc["last_score"], jc["last_score"])
    else:
        last = _last_tick_scores(payloads)
        for k, v in zip(tag_keys.tolist(), pc["last_score"].tolist()):
            assert v in last.get(k, {0}), (k, v, last.get(k))
    assert _counter(pe) == _counter(je)


def test_twitter_scoring_exact(run, jax_trace_shim):
    """Sign-split totals and the first-activation counter match the
    reference semantics exactly, on both sides."""
    tweets = [
        {"hashtags": ["jax", "tpu"], "score": 1},
        {"hashtags": ["jax"], "score": -1},
        {"hashtags": ["tpu"], "score": 0},
        {"hashtags": ["jax", "xla"], "score": 1},
    ]
    tags = np.asarray([port_tw.hashtag_key(t) for t in ("jax", "tpu",
                                                         "xla")], np.int64)
    assert tags.tolist() == [jax_tw.hashtag_key(t)
                             for t in ("jax", "tpu", "xla")]
    second = np.asarray([port_tw.hashtag_key("jax"),
                         port_tw.hashtag_key("new")], np.int64)

    async def go(engine, mod):
        engine.arena_for("HashtagGrain").reserve(16)
        engine.arena_for("TweetCounterGrain").reserve(1)
        flat = mod.flatten_tweets(tweets)
        engine.send_batch("HashtagGrain", "add_score", flat["keys"],
                          {"score": flat["scores"]})
        await engine.flush()
        np.testing.assert_array_equal(
            _col(engine, "HashtagGrain", "total", tags), [3, 2, 1])
        np.testing.assert_array_equal(
            _col(engine, "HashtagGrain", "positive", tags), [2, 1, 1])
        np.testing.assert_array_equal(
            _col(engine, "HashtagGrain", "negative", tags), [1, 0, 0])
        assert _counter(engine) == 3
        engine.send_batch("HashtagGrain", "add_score", second,
                          {"score": np.asarray([1, -1], np.int32)})
        await engine.flush()
        assert _counter(engine) == 4

    je, pe = _engines()
    run(go(je, jax_tw))
    run(go(pe, port_tw))
    flat = port_tw.flatten_tweets(tweets)
    _assert_hashtags_twin(je, pe, np.concatenate([tags, second[1:]]),
                          [(flat["keys"], flat["scores"]),
                           (second, np.asarray([1, -1], np.int32))])


def test_twitter_load_driver(run, jax_trace_shim):
    je, pe = _engines()
    js = run(jax_tw.run_twitter_load(je, n_tweets_per_tick=1000,
                                     n_hashtags=50, tags_per_tweet=2,
                                     n_ticks=3))
    ps = run(port_tw.run_twitter_load(pe, n_tweets_per_tick=1000,
                                      n_hashtags=50, tags_per_tweet=2,
                                      n_ticks=3))
    assert int(pe.arena_for("HashtagGrain").state["total"].sum()) \
        == 1000 * 2 * 3
    assert 0 < _counter(pe) <= 50
    assert ps["messages"] == (2000 + 1000) * 3
    assert set(ps) == set(js)
    tag_keys, payloads = port_tw._zipf_payloads(50, 2000, 3, 1.4, 0)
    seen = np.unique(np.concatenate([k for k, _ in payloads]))
    _assert_hashtags_twin(je, pe, seen, payloads)


def test_twitter_fused_matches_unfused(run, jax_trace_shim):
    """The fused tier (dispatcher pool, per-tick slab args, in-window
    hashtag resolve) gives the unfused engine's hashtag sums and counter,
    on the port and against JAX's fused run."""
    n_tweets, n_tags, ticks = 2_000, 300, 8
    plain = TensorEngine(device="cpu")
    run(port_tw.run_twitter_load(plain, n_tweets_per_tick=n_tweets,
                                 n_hashtags=n_tags, n_ticks=ticks,
                                 warm_ticks=0, seed=3))
    je, fused = _engines()
    run(jax_tw.run_twitter_load_fused(je, n_tweets_per_tick=n_tweets,
                                      n_hashtags=n_tags, n_ticks=ticks,
                                      window=4, seed=3))
    stats = run(port_tw.run_twitter_load_fused(
        fused, n_tweets_per_tick=n_tweets, n_hashtags=n_tags,
        n_ticks=ticks, window=4, seed=3))
    assert stats["engine"] == "fused"
    tag_keys, payloads = port_tw._zipf_payloads(n_tags, n_tweets * 2,
                                                ticks, 1.4, 3)
    seen = np.unique(np.concatenate([k for k, _ in payloads]))
    pc, fc = _hashtag_cols(plain, seen), _hashtag_cols(fused, seen)
    for f in ("total", "positive", "negative", "counted"):
        np.testing.assert_array_equal(fc[f], pc[f], err_msg=f)
    assert _counter(fused) == _counter(plain)
    _assert_hashtags_twin(je, fused, tag_keys, payloads)


def test_twitter_grouped_bit_exact_vs_ungrouped(run, jax_trace_shim):
    """The grouped pull-mode path (K16's plain version) equals the
    ungrouped run in every sum and the counter, and JAX's grouped run in
    every column; its ``last_score`` is each tag's last lane of its last
    tick, exactly."""
    e1 = TensorEngine(device="cpu")
    run(port_tw.run_twitter_load_grouped(e1, n_tweets_per_tick=2_000,
                                         n_hashtags=500, n_ticks=4,
                                         window=4))
    e2 = TensorEngine(device="cpu")
    run(port_tw.run_twitter_load(e2, n_tweets_per_tick=2_000,
                                 n_hashtags=500, n_ticks=4))
    j1 = JaxTensorEngine()
    run(jax_tw.run_twitter_load_grouped(j1, n_tweets_per_tick=2_000,
                                        n_hashtags=500, n_ticks=4,
                                        window=4))
    tag_keys, payloads = port_tw._zipf_payloads(500, 4_000, 4, 1.4, 0)
    a1, a2 = (e.arena_for("HashtagGrain") for e in (e1, e2))
    r1, ok1 = a1.lookup_rows(tag_keys)
    r2, ok2 = a2.lookup_rows(tag_keys)
    assert ok1.all()
    for f in ("total", "positive", "negative", "counted"):
        x1 = a1.state[f].numpy()[r1]
        x2 = a2.state[f].numpy()[r2]
        np.testing.assert_array_equal(x1[ok2], x2[ok2], err_msg=f)
        assert not np.any(x1[~ok2]), f  # untouched keys stay init
    assert _counter(e1) == _counter(e2)
    _assert_hashtags_twin(j1, e1, tag_keys)
    # each row's last lane: the last score each tag received
    want = np.zeros(len(tag_keys), np.int64)
    index = {int(k): i for i, k in enumerate(tag_keys.tolist())}
    for keys, scores in payloads:
        for k, s in zip(keys.tolist(), scores.tolist()):
            want[index[k]] = s
    np.testing.assert_array_equal(a1.state["last_score"].numpy()[r1], want)
