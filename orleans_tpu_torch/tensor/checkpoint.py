"""Durable state plane: columnar checkpoints, device journal, recovery.

The port of ``orleans_tpu/tensor/checkpoint.py``, at one shard block.  A
silo that dies loses every grain not already written back; this module is
durability done the columnar way, three structures and one recovery path:

* **whole-arena columnar checkpoints** — a recovery point is a consistent
  cut pinned at a tick boundary (between ticks no message is half
  applied): one K19 ``pin_columns`` launch copies every state column and
  the device use clock of an arena, and its chunks then drain to the
  store between ticks under ``ckpt_pause_budget_s`` while live ticks keep
  updating the real columns in place — the asynchronous-snapshot
  discipline (Chandy-Lamport; Flink's asynchronous barrier snapshots).
  Each chunk is one K20 ``gather_columns`` launch into one packed staging
  buffer and one device-to-host copy into pinned memory.  The payload
  carries the arena's identity metadata (key→row map, bump pointer,
  generation, eviction epoch, the host use clock, replica groups), so a
  restore reconstructs row identity exactly, not just per-key state.
  The pin is a copy, never a view: a tensor changes in place, where a
  JAX array cannot.
* **incremental deltas** — between fulls only rows whose traffic counts
  (the attribution plane) moved since the last cut, or whose use clocks
  reached it, re-checkpoint: one K21 ``dirty_mask`` launch, only the bool
  mask crosses to the host.  Rows are also compared by key against the
  pinned key→row map (evict and slot reuse), and replica groups are
  always dirty.  A generation change promotes the next delta to a full.
* **a device journal** — registered ingress sites append each batch to a
  per-site log.  Device leaves are copied on append (K19, one launch per
  batch), since a caller or the injector may rewrite the tensor before the
  seal; a leaf presented again unchanged — same tensor, same in-place
  version — is stored once per segment.  Host numpy leaves intern by
  identity and content, scalars ride per-entry metadata.  A seal packs
  every buffered device leaf with K19 and fetches them with one
  device-to-host copy into pinned memory.  A segment becomes durable
  (acknowledged) when its blob and the manifest commit land; lanes past
  the committed horizon are the loss window of a hard kill.
* **crash recovery** — ``recover()`` rebuilds every arena from the latest
  committed recovery point (full plus deltas in order), restores the
  timers plane's cut, then fold-replays the journal tail: entries group by
  their original tick and re-inject as whole batches — one engine tick per
  journaled tick, or runs of consecutive ticks as one stacked fused window
  (``FusedTickProgram.replay``; on the card one captured CUDA graph per
  window signature) — so emits re-fire deterministically and integer
  state comes back bit-exact (``samples/banking.py`` is the oracle).

Commit protocol: blobs first, manifest last, the manifest replaced
atomically (tmp, fsync, rename) — a kill at any byte offset leaves the old
recovery point or the new one, never a torn mix.  A manifest that names a
missing blob is an error at recovery, not a silent skip.

``StandbyTailer`` is log shipping over the same store: a standby adopts
committed fulls and deltas and stages sealed journal segments while the
primary runs; ``promote()`` fences the store (the old primary's next
commit raises ``FencedError``) and replays only the staged tail.

Blob and manifest formats are exactly the JAX package's, so a recovery
point written by the JAX package restores into the port.  A recovery
point of several shard blocks, migration pins and the silo's startup
wiring belong to later slices of the port.
"""

from __future__ import annotations

import json
import os
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from orleans_tpu_torch.device import fetch_host, host_upload, pow2_pad
from orleans_tpu_torch.kernels.checkpoint import (
    dirty_mask,
    fetch_columns,
    fetch_packed,
    gather_columns,
    pin_columns,
)
from orleans_tpu_torch.tensor.arena import np_dtype
from orleans_tpu_torch.tensor.attribution import pow2ceil
from orleans_tpu_torch.tensor.persistence import fsync_write


# ---------------------------------------------------------------------------
# snapshot stores
# ---------------------------------------------------------------------------

class SnapshotStore:
    """Blob and manifest contract of the durable state plane.  Blobs are
    named dicts of numpy arrays with a small JSON meta; the MANIFEST is the
    single atomic commit pointer — a recovery point exists exactly when
    the manifest naming it is readable."""

    def put_blob(self, name: str, arrays: Dict[str, np.ndarray],
                 meta: Optional[Dict[str, Any]] = None) -> int:
        """Write a blob durably; returns approximate bytes written."""
        raise NotImplementedError

    def get_blob(self, name: str
                 ) -> Optional[Tuple[Dict[str, np.ndarray], Dict[str, Any]]]:
        raise NotImplementedError

    def delete_blob(self, name: str) -> None:
        raise NotImplementedError

    def read_manifest(self) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def commit_manifest(self, manifest: Dict[str, Any]) -> None:
        """Atomic replace: the durability acknowledgement point."""
        raise NotImplementedError


class MemorySnapshotStore(SnapshotStore):
    """In-process store; share ``backing`` across engines to model a
    durable medium that survives a hard kill.  Arrays are copied on write
    (a reused staging buffer must never reach a committed snapshot)."""

    def __init__(self, backing: Optional[Dict] = None) -> None:
        self._b = backing if backing is not None else {}
        self._b.setdefault("blobs", {})

    @staticmethod
    def shared_backing() -> Dict:
        return {}

    def put_blob(self, name, arrays, meta=None):
        copied = {k: np.asarray(v).copy() for k, v in arrays.items()}
        self._b["blobs"][name] = (copied, dict(meta or {}))
        return int(sum(a.nbytes for a in copied.values()))

    def get_blob(self, name):
        ent = self._b["blobs"].get(name)
        if ent is None:
            return None
        arrays, meta = ent
        return ({k: v.copy() for k, v in arrays.items()}, dict(meta))

    def delete_blob(self, name):
        self._b["blobs"].pop(name, None)

    def read_manifest(self):
        m = self._b.get("manifest")
        return json.loads(m) if m is not None else None

    def commit_manifest(self, manifest):
        # through JSON: the manifest stays plain data (the file store
        # round-trips it), and the assignment is atomic
        self._b["manifest"] = json.dumps(manifest)


class FileSnapshotStore(SnapshotStore):
    """On-disk store: one ``.npz`` per blob under ``root``, the manifest as
    ``MANIFEST.json``.  Every write is tmp, fsync, atomic rename
    (``fsync_write``), and blobs land before the manifest naming them, so
    a kill at any point leaves a readable store."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, name: str) -> str:
        if "/" in name or "\\" in name or name.startswith("."):
            raise ValueError(f"bad blob name {name!r}")
        return os.path.join(self.root, name + ".npz")

    def put_blob(self, name, arrays, meta=None):
        payload = {k: np.asarray(v) for k, v in arrays.items()}
        payload["__meta__"] = np.frombuffer(
            json.dumps(meta or {}).encode(), dtype=np.uint8)
        path = self._path(name)
        fsync_write(path, lambda f: np.savez(f, **payload))
        return int(os.path.getsize(path))

    def get_blob(self, name):
        path = self._path(name)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
            meta = json.loads(z["__meta__"].tobytes().decode()) \
                if "__meta__" in z.files else {}
        return arrays, meta

    def delete_blob(self, name):
        try:
            os.remove(self._path(name))
        except FileNotFoundError:
            pass

    def read_manifest(self):
        path = os.path.join(self.root, "MANIFEST.json")
        try:
            with open(path, "r") as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except json.JSONDecodeError:
            # an atomically renamed manifest is never torn: a torn one
            # predates fsync_write — no recovery point rather than a crash
            return None

    def commit_manifest(self, manifest):
        fsync_write(os.path.join(self.root, "MANIFEST.json"),
                    lambda f: f.write(json.dumps(manifest, indent=1)
                                      .encode()),
                    binary=True)


# ---------------------------------------------------------------------------
# args trees (plain dict / list / tuple walks)
# ---------------------------------------------------------------------------

def _tree_skeleton(obj) -> Tuple[Dict[str, Any], int]:
    """JSON-able skeleton of an args tree (dict / list / tuple nesting,
    dict keys sorted); leaves become integer slots in flatten order."""
    slot = [0]

    def walk(o):
        if isinstance(o, dict):
            return {"t": "d", "k": {k: walk(o[k]) for k in sorted(o)}}
        if isinstance(o, (list, tuple)):
            return {"t": "l" if isinstance(o, list) else "u",
                    "c": [walk(c) for c in o]}
        i = slot[0]
        slot[0] += 1
        return {"t": "x", "i": i}

    return walk(obj), slot[0]


def _skeleton_flatten(obj, out: List[Any]) -> List[Any]:
    if isinstance(obj, dict):
        for k in sorted(obj):
            _skeleton_flatten(obj[k], out)
    elif isinstance(obj, (list, tuple)):
        for c in obj:
            _skeleton_flatten(c, out)
    else:
        out.append(obj)
    return out


def _skeleton_unflatten(skel, leaves: List[Any]):
    t = skel["t"]
    if t == "d":
        return {k: _skeleton_unflatten(v, leaves)
                for k, v in skel["k"].items()}
    if t in ("l", "u"):
        seq = [_skeleton_unflatten(c, leaves) for c in skel["c"]]
        return seq if t == "l" else tuple(seq)
    return leaves[skel["i"]]


# ---------------------------------------------------------------------------
# the device journal
# ---------------------------------------------------------------------------

class _JournalSite:
    """One journaled ingress (type, method): the open segment's state."""

    __slots__ = ("type_name", "method", "key", "skeleton", "n_slots",
                 "capacity", "entries", "dev_arrays", "dev_index",
                 "host_arrays", "host_index", "seq", "committed_lanes",
                 "committed_tick", "appended_lanes", "segment_lanes")

    def __init__(self, type_name: str, method: str, capacity: int) -> None:
        self.type_name = type_name
        self.method = method
        self.key = f"{type_name}.{method}"
        self.skeleton = None          # args tree skeleton (JSON-able)
        self.n_slots = 0
        self.capacity = capacity      # buffered-lane bound → forced seal
        self.entries: List[Dict[str, Any]] = []
        # copies of the open segment's device leaves (K19 on append)
        self.dev_arrays: List[torch.Tensor] = []
        # id(caller's tensor) → (index, its in-place version, weakref):
        # a steady injector presenting the same unchanged tensor stores
        # it once per segment
        self.dev_index: Dict[int, Tuple[int, int, Any]] = {}
        # identity- and content-interned host numpy leaves
        self.host_arrays: List[np.ndarray] = []
        self.host_index: Dict[int, Tuple[Any, int]] = {}
        self.seq = 0                  # next segment seq
        self.committed_lanes = 0      # lanes sealed into durable segments
        self.committed_tick = -1
        self.appended_lanes = 0
        self.segment_lanes = 0        # lanes in the open (not durable) one


class DeviceJournal:
    """Per-site append logs and the segment seal and replay machinery.

    Append cost: a device leaf is copied on the card (one K19 launch for
    every new device leaf of the batch; a leaf presented again unchanged
    costs a dictionary lookup), a host leaf an identity lookup with a
    content compare on a hit, a scalar nothing.  The device-to-host copy
    happens once per seal, never per event or per tick."""

    def __init__(self, engine, plane: "CheckpointPlane") -> None:
        self._engine = weakref.ref(engine)
        self.plane = plane
        self.sites: Dict[Tuple[str, str], _JournalSite] = {}
        self._order = 0               # global append order stamp
        self.ring_overflows = 0
        self.segments_committed = 0
        self.flush_seconds = 0.0
        self.replayed_lanes = 0

    def register(self, type_name: str, method: str) -> _JournalSite:
        key = (type_name, method)
        site = self.sites.get(key)
        if site is None:
            cap = pow2ceil(self.plane.config().journal_ring_lanes)
            site = _JournalSite(type_name, method, cap)
            self.sites[key] = site
        return site

    # -- append -------------------------------------------------------------

    def _intern_host(self, site: _JournalSite, a: np.ndarray) -> int:
        """Identity and content interning of a host leaf (a loader may
        rewrite the same buffer in place between ticks)."""
        ent = site.host_index.get(id(a))
        if ent is not None:
            ref, idx = ent
            if ref() is a and np.array_equal(a, site.host_arrays[idx]):
                return idx
        idx = len(site.host_arrays)
        site.host_arrays.append(np.asarray(a).copy())
        try:
            site.host_index[id(a)] = (weakref.ref(a), idx)
        except TypeError:
            pass  # not weakrefable: stored, never deduped
        return idx

    def _intern_dev(self, site: _JournalSite, leaves: List[torch.Tensor]
                    ) -> List[int]:
        """Indices of ``leaves`` in the open segment: a tensor presented
        before and unwritten since (same identity and in-place version)
        reuses its copy; the rest are copied with one K19 launch."""
        out: List[Optional[int]] = []
        fresh: List[torch.Tensor] = []
        for a in leaves:
            ent = site.dev_index.get(id(a))
            if ent is not None and ent[2]() is a and ent[1] == a._version:
                out.append(ent[0])
            else:
                out.append(None)
                fresh.append(a)
        if fresh:
            uniq = list({id(a): a for a in fresh}.values())
            copies = pin_columns(uniq)
            for a, c in zip(uniq, copies):
                idx = len(site.dev_arrays)
                site.dev_arrays.append(c)
                site.dev_index[id(a)] = (idx, a._version, weakref.ref(a))
            out = [site.dev_index[id(a)][0] if i is None else i
                   for a, i in zip(leaves, out)]
        return out

    def append(self, type_name: str, method: str, batch) -> None:
        """Journal one ingress batch (``send_batch`` or an injector's
        ``inject``).  A full site seals its open segment first (counted as
        a ring overflow) instead of raising into the hot path."""
        site = self.sites.get((type_name, method))
        if site is None:
            return
        args = batch.args
        skel, n_slots = _tree_skeleton(args)
        if site.skeleton is None:
            site.skeleton = skel
            site.n_slots = n_slots
        elif skel != site.skeleton:
            # a site changing its args structure: seal the open segment
            # under the old skeleton and re-spec
            self.flush(site)
            site.skeleton = skel
            site.n_slots = n_slots
        leaves = _skeleton_flatten(args, [])
        keys_host = batch.keys_host
        keys_dev = batch.keys_dev if keys_host is None else None
        if keys_host is None and keys_dev is None:
            raise ValueError(
                f"journal site {site.key}: ingress batch carries neither "
                f"host nor device keys (wide-key ingress is not "
                f"journalable — hash identities into the int domain)")
        lanes = len(keys_host) if keys_host is not None else len(keys_dev)
        if site.segment_lanes + lanes > site.capacity and site.entries:
            self.ring_overflows += 1
            self.flush(site)
        entry: Dict[str, Any] = {"tick": int(batch.inject_tick),
                                 "order": self._order, "lanes": int(lanes),
                                 "refs": []}
        self._order += 1
        dev = [x for x in leaves
               if isinstance(x, torch.Tensor) and x.dim() >= 1]
        if keys_host is None:
            dev.append(keys_dev)
        dev_idx = iter(self._intern_dev(site, dev)) if dev else iter(())
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor) and leaf.dim() >= 1:
                # any-width device leaf: lane-aligned payloads and
                # per-batch constants (lookup tables) alike
                entry["refs"].append({"k": "d", "i": next(dev_idx)})
            elif isinstance(leaf, np.ndarray) and leaf.ndim >= 1:
                entry["refs"].append(
                    {"k": "h", "i": self._intern_host(site, leaf)})
            else:
                # a scalar or 0-d leaf rides the entry's metadata
                v = leaf.cpu().numpy() if isinstance(leaf, torch.Tensor) \
                    else np.asarray(leaf)
                entry["refs"].append({"k": "s", "v": v.item(),
                                      "d": str(v.dtype)})
        if keys_host is not None:
            entry["keys"] = {"k": "h",
                             "i": self._intern_host(site, keys_host)}
        else:
            entry["keys"] = {"k": "d", "i": next(dev_idx)}
        site.entries.append(entry)
        site.appended_lanes += lanes
        site.segment_lanes += lanes

    # -- seal / durability --------------------------------------------------

    def pending_lanes(self) -> int:
        return sum(s.segment_lanes for s in self.sites.values())

    def flush(self, site: Optional[_JournalSite] = None) -> int:
        """Seal the open segment(s) durable: one device-to-host copy of
        every buffered device leaf per site (K19 packs them), every
        segment blob first, then ONE manifest commit covering every sealed
        site.  Returns segments committed: everything sealed survives a
        hard kill, everything still buffered does not."""
        t0 = time.perf_counter()
        sites = [site] if site is not None else list(self.sites.values())
        sealed: List[Tuple[_JournalSite, str, Dict[str, Any]]] = []
        for s in sites:
            if not s.entries:
                continue
            arrays: Dict[str, np.ndarray] = {}
            for i, a in enumerate(fetch_columns(s.dev_arrays)):
                arrays[f"d{i}"] = a
            for i, a in enumerate(s.host_arrays):
                arrays[f"h{i}"] = a
            ticks = [e["tick"] for e in s.entries]
            meta = {"site": [s.type_name, s.method], "seq": s.seq,
                    "skeleton": s.skeleton, "entries": s.entries,
                    "lanes": s.segment_lanes, "tick_min": min(ticks),
                    "tick_max": max(ticks)}
            blob = f"journal-{s.key}-{s.seq:08d}"
            self.plane.store.put_blob(blob, arrays, meta)
            sealed.append((s, blob, meta))
        if sealed:
            self.plane._journal_commit(sealed)
            for s, _blob, meta in sealed:
                s.seq += 1
                s.committed_lanes += s.segment_lanes
                s.committed_tick = meta["tick_max"]
                s.entries = []
                s.dev_arrays = []
                s.dev_index = {}
                s.host_arrays = []
                s.host_index = {}
                s.segment_lanes = 0
                self.segments_committed += 1
        self.flush_seconds += time.perf_counter() - t0
        return len(sealed)

    # -- replay -------------------------------------------------------------

    @staticmethod
    def decode_segment(arrays: Dict[str, np.ndarray],
                       meta: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Segment blob → replayable entries ``{tick, order, keys, args}``
        with numpy leaves."""
        def resolve(ref):
            if ref["k"] == "d":
                return arrays[f"d{ref['i']}"]
            if ref["k"] == "h":
                return arrays[f"h{ref['i']}"]
            return np.dtype(ref["d"]).type(ref["v"])

        out = []
        skel = meta["skeleton"]
        for e in meta["entries"]:
            leaves = [resolve(ref) for ref in e["refs"]]
            out.append({"tick": e["tick"], "order": e["order"],
                        "keys": np.asarray(resolve(e["keys"])),
                        "args": _skeleton_unflatten(skel, leaves)})
        return out

    def snapshot(self) -> Dict[str, Any]:
        return {
            "sites": {s.key: {"appended_lanes": s.appended_lanes,
                              "committed_lanes": s.committed_lanes,
                              "pending_lanes": s.segment_lanes,
                              "segments": s.seq,
                              "committed_tick": s.committed_tick}
                      for s in self.sites.values()},
            "segments_committed": self.segments_committed,
            "ring_overflows": self.ring_overflows,
            "pending_lanes": self.pending_lanes(),
            "flush_seconds": round(self.flush_seconds, 6),
            "replayed_lanes": self.replayed_lanes,
        }


# ---------------------------------------------------------------------------
# the checkpoint plane
# ---------------------------------------------------------------------------

class _ActiveSnapshot:
    """One in-progress (pinned, draining) snapshot."""

    __slots__ = ("kind", "tick", "seq", "arenas", "queue", "bytes",
                 "rows", "parts", "started", "timers")

    def __init__(self, kind: str, tick: int, seq: int) -> None:
        self.kind = kind              # "full" | "delta"
        self.tick = tick              # the consistent-cut tick
        self.seq = seq
        self.arenas: Dict[str, Dict[str, Any]] = {}
        self.queue: List[Tuple[str, int]] = []  # (type, chunk index)
        self.bytes = 0
        self.rows = 0
        self.parts: Dict[str, List[str]] = {}
        self.started = time.perf_counter()
        # the timers plane's export pinned with the cut: (arrays, meta)
        # for one blob, or None when nothing is armed or logged
        self.timers: Any = None


class FencedError(RuntimeError):
    """The store's manifest carries a newer promotion-fence epoch than
    this plane holds: a promoted standby has claimed the store.  Every
    commit path raises this instead of acknowledging — the old primary,
    even if merely partitioned, never serves a durable write after its
    range was claimed."""


class CheckpointPlane:
    """The engine's durable state plane (attach a SnapshotStore to
    engage).  Every public entry point is host-synchronous and runs
    between ticks: ``on_tick`` is the engine hook, ``checkpoint_full`` /
    ``checkpoint_delta`` drive a snapshot to completion, ``recover`` is
    the restart path."""

    def __init__(self, engine, store: Optional[SnapshotStore] = None
                 ) -> None:
        self._engine = weakref.ref(engine)
        self.store = store
        self.journal = DeviceJournal(engine, self)
        self._active: Optional[_ActiveSnapshot] = None
        self._manifest: Optional[Dict[str, Any]] = None
        self._seq = 0
        self._last_full_tick = -1
        self._last_ckpt_tick = -1     # last committed recovery point
        self._last_journal_flush_tick = 0
        # per-arena delta baseline: (generation, host key map, device
        # counts copy | None, pin tick)
        self._delta_pin: Dict[str, Tuple] = {}
        self._replaying = False
        # emit-destination keys per journaled site (register_journal's
        # emit_key_args): recovery activates their union before fused
        # replay, so a window never misses on a cold emit destination
        self._emit_key_args: Dict[Tuple[str, str], Tuple[str, ...]] = {}
        # the promotion fence epoch this plane holds
        self.fence_epoch = 0
        self._fence_owner = ""
        self.fenced = False
        self.on_fenced: Optional[Any] = None  # the owner's kill hook
        self.full_snapshots = 0
        self.delta_snapshots = 0
        self.rows_written = 0
        self.bytes_written = 0
        self.restored_rows = 0
        self.last_restore_s = 0.0
        self.last_dirty_rows = 0
        self.pauses: List[float] = []
        self.max_pause_s = 0.0
        self.replay_fused_windows = 0
        self.replay_fused_lanes = 0
        self.promotions = 0
        self.last_rto_s = 0.0
        if store is not None:
            self._read_store_manifest()

    # -- plumbing -----------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.store is not None

    def engine(self):
        return self._engine()

    def config(self):
        return self.engine().config

    def _read_store_manifest(self) -> None:
        m = self.store.read_manifest()
        if m is not None:
            self._manifest = m
            self._seq = int(m.get("seq", 0)) + 1
            self._last_ckpt_tick = int(
                (m.get("recovery") or {}).get("tick", -1))
            self.fence_epoch = int((m.get("fence") or {}).get("epoch", 0))

    def attach_store(self, store: SnapshotStore) -> None:
        """Late binding (tests, setup hooks, standby promotion): engage
        the plane on a running engine."""
        self.store = store
        self._read_store_manifest()

    def register_journal(self, interface, method: str,
                         emit_key_args: Tuple[str, ...] = ()) -> None:
        """``emit_key_args``: names of arg leaves whose values are emit
        destination keys of this same grain type (banking transfer's
        ``dst``) — recovery activates their union so fused replay windows
        never roll back on cold emit targets."""
        eng = self.engine()
        type_name = eng._type_name(interface)
        self.journal.register(type_name, method)
        eng._journal_sites.add((type_name, method))
        if emit_key_args:
            self._emit_key_args[(type_name, method)] = tuple(emit_key_args)

    def journal_ingress(self, type_name: str, method: str, batch) -> None:
        if self._replaying or not self.enabled:
            return
        self.journal.append(type_name, method, batch)

    def durable_horizon(self) -> Dict[str, Any]:
        """What is acknowledged durable now: the committed recovery-point
        tick and each journal site's committed lanes and tick."""
        return {
            "recovery_tick": self._last_ckpt_tick,
            "journal": {s.key: {"committed_lanes": s.committed_lanes,
                                "committed_tick": s.committed_tick}
                        for s in self.journal.sites.values()},
        }

    # -- promotion fence ----------------------------------------------------

    def _check_fence(self) -> None:
        """Re-read the store's fence epoch before a commit: a newer epoch
        means a standby promoted over this store — refuse."""
        m = self.store.read_manifest()
        cur = int(((m or {}).get("fence") or {}).get("epoch", 0))
        if cur > self.fence_epoch:
            self.fenced = True
            raise FencedError(
                f"snapshot store fenced at epoch {cur} (this plane holds "
                f"{self.fence_epoch}) — a standby promoted over this "
                f"store; refusing to commit")

    def acquire_fence(self, owner: str = "") -> int:
        """Claim the store: bump the manifest's fence epoch with one
        commit.  From then on every other plane attached to the store
        fails its next commit with FencedError.  Returns the epoch."""
        m = self.store.read_manifest() or {}
        epoch = int((m.get("fence") or {}).get("epoch", 0)) + 1
        m["fence"] = {"epoch": epoch, "owner": owner}
        m["seq"] = self._seq
        self._seq += 1
        self.store.commit_manifest(m)
        self._manifest = m
        self.fence_epoch = epoch
        self._fence_owner = owner
        return epoch

    # -- cadence / engine hook ----------------------------------------------

    def _quiescent_for_pin(self) -> bool:
        """A pin is a consistent cut only when nothing is half-delivered:
        no parked miss or fan-out checks, no queued work, and no tick
        buffered by the auto-fuser.  A buffered tick was journaled at its
        injection, stamped with the tick clock of then, which a fused
        stretch does not advance: pinned while it waits (the ticks a flush
        or a pattern break replays one by one), it would run after the cut
        with a stamp before it, and the replay filter and the prune at the
        next full would drop an acknowledged write."""
        eng = self.engine()
        return not (eng._pending_checks or eng._fanout_checks
                    or any(eng.queues.values())
                    or eng.autofuser.has_buffer())

    def on_tick(self) -> float:
        """The run_tick hook: start a due snapshot, drain one pause-
        budgeted slice, keep the journal cadence.  Returns host seconds
        spent (the ``checkpoint`` stage)."""
        if not self.enabled or self._replaying:
            return 0.0
        eng = self.engine()
        cfg = eng.config
        t0 = time.perf_counter()
        did = False
        if self._active is None:
            full_due = cfg.ckpt_full_every_ticks > 0 and \
                eng.tick_number - max(self._last_full_tick, 0) \
                >= cfg.ckpt_full_every_ticks
            delta_due = cfg.ckpt_delta_every_ticks > 0 and \
                self._last_full_tick >= 0 and \
                eng.tick_number - max(self._last_ckpt_tick, 0) \
                >= cfg.ckpt_delta_every_ticks
            if (full_due or delta_due) and not self._quiescent_for_pin():
                # parked checks under steady emit traffic would starve the
                # cadence: force the drain; if it queued redeliveries the
                # pin waits one tick (their stamps predate the cut)
                eng._drain_checks()
                did = True
            if (full_due or delta_due) and self._quiescent_for_pin():
                self.begin("full" if full_due else "delta")
                did = True
        try:
            if self._active is not None:
                self.run_slice(cfg.ckpt_pause_budget_s)
                did = True
            if cfg.journal_flush_every_ticks > 0 and \
                    eng.tick_number - self._last_journal_flush_tick \
                    >= cfg.journal_flush_every_ticks:
                self._last_journal_flush_tick = eng.tick_number
                if self.journal.pending_lanes():
                    self.journal.flush()
                    did = True
        except FencedError:
            # a standby promoted over this store: nothing further can be
            # acknowledged — drop the snapshot in flight, stop journaling
            # and hand control to the owner's hook
            self._active = None
            self.store = None
            cb, self.on_fenced = self.on_fenced, None
            if cb is not None:
                cb()
            return time.perf_counter() - t0
        if not did:
            return 0.0
        dt = time.perf_counter() - t0
        self.pauses.append(dt)
        if len(self.pauses) > 1024:
            del self.pauses[:512]
        self.max_pause_s = max(self.max_pause_s, dt)
        return dt

    # -- snapshot lifecycle -------------------------------------------------

    def begin(self, kind: str) -> None:
        """Pin the consistent cut: settle the fused chain, seal the journal
        at the cut, one K19 copy per arena plus host metadata copies.
        O(live arenas) host work; the drain runs in later slices."""
        if self._active is not None:
            raise RuntimeError("snapshot already in progress")
        eng = self.engine()
        if eng.autofuser._unverified:
            # the pin must capture verified state: an unverified chain
            # proves exact or rolls back and replays now
            eng.autofuser._settle_chain()
        # the attribution plane's buffered folds are not flushed here:
        # stale counts can only under-report "moved", and every such row's
        # use clock reached the pin tick, which the clock term catches
        pin_tick = eng.tick_number
        # the journal horizon: everything at or before the cut seals with
        # the snapshot; replay after a restore starts at tick >= pin_tick
        self.journal.flush()
        snap = _ActiveSnapshot(kind, pin_tick, self._seq)
        self._seq += 1
        chunk = max(1, int(eng.config.ckpt_chunk_rows))
        for name, arena in eng.arenas.items():
            live_rows = np.nonzero(arena._key_of_row >= 0)[0]
            part_kind = kind
            if kind == "delta":
                pin = self._delta_pin.get(name)
                if pin is None or pin[0] != arena.generation:
                    # no pin yet, or rows moved since: delta row ids would
                    # lie — this arena's part becomes a full
                    part_kind = "full"
                else:
                    live_rows = self._dirty_rows(arena, pin)
            if part_kind == "full" and kind == "delta":
                snap.kind = "full"  # an all-full delta IS a full
            names = list(arena.state) + ["__last_use_dev"]
            pinned = pin_columns(list(arena.state.values())
                                 + [arena.last_use_dev])
            meta = arena.export_layout()
            meta["tick"] = pin_tick
            meta["kind"] = part_kind
            snap.arenas[name] = {
                "pin": dict(zip(names, pinned)),
                "meta": meta,
                "rows": live_rows.astype(np.int64),
                "chunk": chunk,
                "n_chunks": -(-len(live_rows) // chunk)
                if len(live_rows) else 0,
            }
            snap.parts[name] = []
            for c in range(snap.arenas[name]["n_chunks"]):
                snap.queue.append((name, c))
        # a promoted part promotes the snapshot: a recovery point is one
        # all-arena cut at one tick
        if snap.kind == "full":
            for name, a in snap.arenas.items():
                if a["meta"]["kind"] == "delta":
                    arena = eng.arenas[name]
                    a["rows"] = np.nonzero(
                        arena._key_of_row >= 0)[0].astype(np.int64)
                    a["meta"]["kind"] = "full"
                    a["n_chunks"] = -(-len(a["rows"]) // a["chunk"]) \
                        if len(a["rows"]) else 0
            snap.queue = [(n, c) for n, a in snap.arenas.items()
                          for c in range(a["n_chunks"])]
        self.last_dirty_rows = sum(
            len(a["rows"]) for a in snap.arenas.values()
            if a["meta"]["kind"] == "delta")
        # the timers plane rides the same cut (after any promotion: its
        # export kind must match the snapshot's)
        snap.timers = eng.timers.export_cut(snap.kind)
        self._active = snap

    def _dirty_rows(self, arena, pin) -> np.ndarray:
        """Rows whose traffic count moved since the pin, or whose use clock
        reached the pin tick (K21), or whose key changed (evict and slot
        reuse), or that belong to a replica group."""
        _gen, pinned_keys, pinned_counts, pin_tick = pin
        eng = self.engine()
        dev = arena.device
        live = arena._key_of_row >= 0
        cutoff = int(np.clip(pin_tick, -2**31 + 1, 2**31 - 1))
        host_clock = np.clip(arena.host_clock(), 0,
                             2**31 - 1).astype(np.int32)
        att = eng.attribution
        counts = None
        if pinned_counts is not None and att.has_state(arena.info.name):
            counts = att.counts_for(arena.info.name)
            if counts.shape != pinned_counts.shape:
                counts = None
        mask = dirty_mask(counts, pinned_counts if counts is not None
                          else None, arena.last_use_dev,
                          host_upload(host_clock, dev),
                          host_upload(live, dev), cutoff)
        dirty = fetch_host({"m": mask})["m"].copy()
        for r in arena._replicas.values():
            # the lane-hash spread lands contributions on secondary rows
            # without advancing the clocks the predicate reads
            dirty[r] = True
        # key churn: rows reused by another grain since the pin (the
        # pinned map is capacity-aligned only while capacity matched)
        n = min(len(pinned_keys), len(arena._key_of_row))
        changed = arena._key_of_row[:n] != pinned_keys[:n]
        dirty[:n] |= changed & live[:n]
        if len(arena._key_of_row) > n:
            dirty[n:] |= live[n:]
        return np.flatnonzero(dirty).astype(np.int64)

    def run_slice(self, budget_s: float) -> int:
        """Drain chunks of the pinned snapshot until the pause budget is
        spent (<= 0 drains everything).  Each chunk is one K20 gather into
        a packed staging buffer and one copy into pinned host memory.  The
        commit rides the final slice.  Returns chunks drained."""
        snap = self._active
        if snap is None:
            return 0
        t0 = time.perf_counter()
        drained = 0
        while snap.queue:
            name, c = snap.queue.pop(0)
            a = snap.arenas[name]
            rows = a["rows"][c * a["chunk"]:(c + 1) * a["chunk"]]
            names = list(a["pin"])
            cols = [a["pin"][k] for k in names]
            # pow2-padded with row 0, as the JAX gather; sliced off below
            idx = host_upload(pow2_pad(rows.astype(np.int32), 0),
                              cols[0].device)
            staging, _views = gather_columns(cols, idx)
            host = fetch_packed(staging, cols, idx.shape[0])
            arrays = {k: v[:len(rows)] for k, v in zip(names, host)}
            arrays["__rows"] = rows
            arrays["__keys"] = a["meta"]["key_of_row"][rows]
            blob = f"ckpt-{snap.seq:08d}-{name}-{c:06d}"
            snap.bytes += self.store.put_blob(
                blob, arrays, {"arena": name, "chunk": c})
            snap.parts[name].append(blob)
            snap.rows += len(rows)
            drained += 1
            if budget_s > 0 and time.perf_counter() - t0 >= budget_s:
                break
        if not snap.queue:
            self._commit_snapshot(snap)
        return drained

    def _commit_snapshot(self, snap: _ActiveSnapshot) -> None:
        self._check_fence()
        eng = self.engine()
        arenas_ref: Dict[str, Any] = {}
        for name, a in snap.arenas.items():
            meta = dict(a["meta"])
            key_of_row = meta.pop("key_of_row")
            last_use = meta.pop("last_use_tick")
            meta_blob = f"ckpt-{snap.seq:08d}-{name}-meta"
            self.store.put_blob(
                meta_blob,
                {"key_of_row": key_of_row, "last_use_tick": last_use,
                 "shard_next": np.asarray(meta.pop("shard_next"),
                                          np.int64),
                 "live_keys": key_of_row[key_of_row >= 0]},
                meta)
            arenas_ref[name] = {"meta": meta_blob,
                                "parts": snap.parts[name],
                                "kind": a["meta"]["kind"]}
        manifest = dict(self._manifest or {})
        rec = dict(manifest.get("recovery") or {"full": None, "deltas": []})
        entry = {"seq": snap.seq, "tick": snap.tick, "arenas": arenas_ref}
        if snap.timers is not None:
            arrays, tmeta = snap.timers
            timers_blob = f"ckpt-{snap.seq:08d}-__timers"
            snap.bytes += self.store.put_blob(timers_blob, arrays, tmeta)
            entry["timers"] = timers_blob
        old_blobs: List[str] = []
        if snap.kind == "full":
            for prev in ([rec.get("full")] if rec.get("full") else []) \
                    + list(rec.get("deltas") or []):
                for ref in prev["arenas"].values():
                    old_blobs.extend(ref["parts"])
                    old_blobs.append(ref["meta"])
                if prev.get("timers"):
                    old_blobs.append(prev["timers"])
            rec = {"full": entry, "deltas": [], "tick": snap.tick}
            self._last_full_tick = snap.tick
        else:
            rec["deltas"] = list(rec.get("deltas") or []) + [entry]
            rec["tick"] = snap.tick
        manifest["seq"] = snap.seq
        manifest["recovery"] = rec
        manifest["engine"] = {"tick_number": eng.tick_number}
        journal = dict(manifest.get("journal") or {})
        if snap.kind == "full":
            # journal segments wholly before the new full are dead
            for key, j in list(journal.items()):
                keep = [s for s in j["segments"]
                        if s["tick_max"] >= snap.tick]
                for s in j["segments"]:
                    if s not in keep:
                        old_blobs.append(s["blob"])
                journal[key] = {"segments": keep}
        manifest["journal"] = journal
        if self.fence_epoch:
            manifest["fence"] = {"epoch": self.fence_epoch,
                                 "owner": self._fence_owner}
        self.store.commit_manifest(manifest)
        self._manifest = manifest
        for blob in old_blobs:
            self.store.delete_blob(blob)
        self._last_ckpt_tick = snap.tick
        # re-pin the delta baseline against the committed cut; the counts
        # pin is a copy (K19), since the plane adds into its column in place
        att = eng.attribution
        for name, arena in eng.arenas.items():
            counts = None
            if att.enabled and att.has_state(name):
                counts = pin_columns([att.counts_for(name)])[0]
            self._delta_pin[name] = (arena.generation,
                                     arena._key_of_row.copy(), counts,
                                     snap.tick)
        if snap.kind == "full":
            self.full_snapshots += 1
        else:
            self.delta_snapshots += 1
        self.rows_written += snap.rows
        self.bytes_written += snap.bytes
        self._active = None

    def _journal_commit(self, sealed: List[Tuple[Any, str, Dict[str, Any]]]
                        ) -> None:
        """Acknowledge freshly written segment blobs with ONE manifest
        commit (the blobs are already durable: blobs first, manifest
        last)."""
        self._check_fence()
        manifest = dict(self._manifest or {})
        journal = dict(manifest.get("journal") or {})
        for site, blob, meta in sealed:
            j = dict(journal.get(site.key) or {"segments": []})
            j["segments"] = list(j["segments"]) + [{
                "seq": site.seq, "blob": blob, "lanes": meta["lanes"],
                "tick_min": meta["tick_min"],
                "tick_max": meta["tick_max"],
            }]
            journal[site.key] = j
        manifest["journal"] = journal
        manifest["seq"] = self._seq
        self._seq += 1
        manifest["engine"] = {"tick_number": self.engine().tick_number}
        manifest.setdefault("recovery",
                            {"full": None, "deltas": [], "tick": -1})
        if self.fence_epoch:
            manifest["fence"] = {"epoch": self.fence_epoch,
                                 "owner": self._fence_owner}
        self.store.commit_manifest(manifest)
        self._manifest = manifest

    # -- explicit sync entry points -----------------------------------------

    def checkpoint_full(self) -> Dict[str, Any]:
        """Pin and drain a full snapshot to its commit, synchronously
        (graceful stop, benches, tests): the pause budget does not
        apply."""
        return self._checkpoint_sync("full")

    def checkpoint_delta(self) -> Dict[str, Any]:
        return self._checkpoint_sync("delta")

    def _checkpoint_sync(self, kind: str) -> Dict[str, Any]:
        if not self.enabled:
            raise RuntimeError("checkpoint plane has no snapshot store")
        if self._active is not None:
            self.run_slice(0.0)  # finish the one in flight first
        if kind == "delta" and self._last_full_tick < 0:
            kind = "full"  # a delta needs a base
        t0 = time.perf_counter()
        self.begin(kind)
        snap = self._active
        self.run_slice(0.0)
        if self._active is not None:
            raise RuntimeError("checkpoint: the drain did not commit")
        return {"kind": snap.kind, "tick": snap.tick, "rows": snap.rows,
                "bytes": snap.bytes,
                "seconds": round(time.perf_counter() - t0, 6)}

    # -- recovery -----------------------------------------------------------

    async def recover(self) -> Dict[str, Any]:
        """Crash recovery: rebuild every arena from the latest committed
        recovery point (full columns assembled on the host and adopted
        with one pinned upload each, deltas as one K3 SET per column),
        restore the timers' cut, fold-replay the journal tail, then
        re-anchor as ``config.recover_reanchor`` says ("sync": a fresh
        full inside recover; "defer": the cadence re-anchors and a second
        crash replays the same tail from the old cut).  A no-op when the
        store holds no manifest."""
        if not self.enabled:
            return {"recovered": False, "reason": "no snapshot store"}
        manifest = self.store.read_manifest()
        if manifest is None:
            return {"recovered": False, "reason": "no manifest"}
        eng = self.engine()
        t0 = time.perf_counter()
        self._manifest = manifest
        self._seq = int(manifest.get("seq", 0)) + 1
        self.fence_epoch = int((manifest.get("fence") or {}).get("epoch", 0))
        rec = manifest.get("recovery") or {}
        restored_rows = 0
        recovery_tick = int(rec.get("tick", -1))
        entries = [rec["full"]] if rec.get("full") else []
        entries += list(rec.get("deltas") or [])
        for entry in entries:
            for name, ref in entry["arenas"].items():
                restored_rows += self._restore_arena_part(
                    name, ref, base=(entry is entries[0]))
            if entry.get("timers"):
                got = self.store.get_blob(entry["timers"])
                if got is None:
                    raise RuntimeError(
                        f"manifest references missing timers blob "
                        f"{entry['timers']} (commit-order contract "
                        f"broken)")
                eng.timers.restore_entry(got[0], got[1])
        if entries:
            # the silent catch-up before the replay: fires acknowledged at
            # or before the cut retire, later ones re-fire exactly once
            eng.timers.finish_restore(recovery_tick)
        replay = self._load_replay_tail(manifest, recovery_tick)
        self._replaying = True
        try:
            if recovery_tick >= 0:
                eng.tick_number = max(eng.tick_number, recovery_tick)
            replayed, fused_windows, fused_lanes = self._fold_replay(replay)
            await eng.flush()
        finally:
            self._replaying = False
        self.journal.replayed_lanes += replayed
        mt = (manifest.get("engine") or {}).get("tick_number")
        if mt is not None:
            eng.tick_number = max(eng.tick_number, int(mt))
        if str(eng.config.recover_reanchor) == "defer":
            # the old recovery point stays the anchor; the tick bump keeps
            # the (tick, order) replay sort unambiguous across restarts
            # (append order counters restart at 0 per process)
            eng.tick_number += 1
            anchor = None
        else:
            anchor = self.checkpoint_full()
        self.restored_rows += restored_rows
        self.last_restore_s = time.perf_counter() - t0
        return {"recovered": True,
                "recovery_tick": recovery_tick,
                "restored_rows": restored_rows,
                "replayed_lanes": replayed,
                "replayed_ticks": len({e["tick"] for e in replay}),
                "fused_windows": fused_windows,
                "fused_lanes": fused_lanes,
                "re_anchor": anchor,
                "seconds": round(self.last_restore_s, 6)}

    def _load_replay_tail(self, manifest: Dict[str, Any],
                          recovery_tick: int,
                          cache: Optional[Dict[str, Any]] = None
                          ) -> List[Dict[str, Any]]:
        """Decode every committed journal entry at or after the cut into
        the global (tick, order) replay order, rebuilding each site's seq
        and committed counters so new segments continue the chain.
        ``cache`` maps blob name → (arrays, meta) for segments already
        staged on the host (the warm standby)."""
        eng = self.engine()
        replay: List[Dict[str, Any]] = []
        for _key, j in (manifest.get("journal") or {}).items():
            for seg in j["segments"]:
                got = (cache or {}).get(seg["blob"]) \
                    or self.store.get_blob(seg["blob"])
                if got is None:
                    raise RuntimeError(
                        f"manifest references missing journal blob "
                        f"{seg['blob']} (commit-order contract broken)")
                arrays, meta = got
                type_name, method = meta["site"]
                for e in DeviceJournal.decode_segment(arrays, meta):
                    if e["tick"] >= recovery_tick:
                        e["type"] = type_name
                        e["method"] = method
                        replay.append(e)
                site = self.journal.register(type_name, method)
                site.seq = max(site.seq, seg["seq"] + 1)
                site.committed_lanes += seg["lanes"]
                # the recovered site's append history is its committed
                # history (pending lanes died with the killed process)
                site.appended_lanes += seg["lanes"]
                site.committed_tick = max(site.committed_tick,
                                          seg["tick_max"])
                eng._journal_sites.add((type_name, method))
        replay.sort(key=lambda e: (e["tick"], e["order"]))
        return replay

    def _fold_replay(self, replay: List[Dict[str, Any]]
                     ) -> Tuple[int, int, int]:
        """Replay the sorted journal tail.  Runs of consecutive ticks with
        a fusable per-site signature run as ONE stacked-rows fused window;
        a window that misses rolls back and replays tick by tick.  Returns
        (replayed lanes, fused windows, fused lanes).  The caller holds
        ``_replaying``."""
        eng = self.engine()
        ticks: List[Tuple[int, List[Dict[str, Any]]]] = []
        for e in replay:
            if ticks and ticks[-1][0] == e["tick"]:
                ticks[-1][1].append(e)
            else:
                ticks.append((e["tick"], [e]))
        cap = int(eng.config.recover_fused_window or 0)
        can_fuse = (cap > 1 and not eng._stream_routes
                    and eng.timers.armed_total == 0)
        if can_fuse:
            # emit-destination pre-activation: activation is field inits
            # only, so state exactness is unaffected; gated on can_fuse so
            # the per-tick path keeps its row identity
            buckets: Dict[str, List[np.ndarray]] = {}
            for e in replay:
                names = self._emit_key_args.get((e["type"], e["method"]))
                if not names or not isinstance(e["args"], dict):
                    continue
                for nm in names:
                    leaf = e["args"].get(nm)
                    if leaf is not None:
                        buckets.setdefault(e["type"], []).append(
                            np.asarray(leaf).reshape(-1))
            for type_name, chunks in buckets.items():
                keys = np.unique(np.concatenate(chunks).astype(np.int64))
                eng.arena_for(type_name).resolve_rows(keys)
        replayed = fused_windows = fused_lanes = 0
        # windows of one signature reuse one program (on the card one
        # captured graph) with the injections swapped in
        prog_cache: Dict[Tuple, Any] = {}
        i = 0
        while i < len(ticks):
            j = self._fused_run_end(ticks, i, cap) if can_fuse else i
            if j - i > 1:
                lanes, was_fused = self._replay_window(ticks[i:j],
                                                       prog_cache)
                replayed += lanes
                if was_fused:
                    fused_windows += 1
                    fused_lanes += lanes
                i = j
                continue
            replayed += self._replay_group_per_tick(ticks[i:i + 1])
            i += 1
        self.replay_fused_windows += fused_windows
        self.replay_fused_lanes += fused_lanes
        return replayed, fused_windows, fused_lanes

    @staticmethod
    def _entry_sig(e: Dict[str, Any]) -> Tuple:
        skel, _ = _tree_skeleton(e["args"])
        leaves = _skeleton_flatten(e["args"], [])
        return (len(e["keys"]), json.dumps(skel, sort_keys=True),
                tuple((np.shape(lf), np.asarray(lf).dtype.str)
                      for lf in leaves))

    def _fused_run_end(self, ticks, i: int, cap: int) -> int:
        """Longest run [i, j) of consecutive ticks one stacked window can
        replay: per-site lane width and args skeleton constant, at most
        one entry per (site, tick), intra-tick site order embeddable in
        one canonical order, and no touched source arena holding replica
        groups (their lane-hash spread is per batch: per-tick replay keeps
        it exact)."""
        eng = self.engine()
        sigs: Dict[Tuple[str, str], Tuple] = {}
        canonical: List[Tuple[str, str]] = []
        j = i
        while j < len(ticks) and j - i < cap:
            tick, entries = ticks[j]
            if j > i and tick != ticks[j - 1][0] + 1:
                break
            seen = set()
            pos = -1
            ok = True
            for e in entries:
                site = (e["type"], e["method"])
                if site in seen:
                    ok = False
                    break
                seen.add(site)
                sig = self._entry_sig(e)
                if sigs.setdefault(site, sig) != sig:
                    ok = False
                    break
                if site in canonical:
                    p = canonical.index(site)
                    if p <= pos:
                        ok = False
                        break
                    pos = p
                else:
                    try:
                        arena = eng.arena_for(e["type"])
                    except KeyError:
                        ok = False
                        break
                    if arena._replicas:
                        ok = False
                        break
                    canonical.insert(pos + 1, site)
                    pos += 1
            if not ok:
                break
            j += 1
        return max(j, i)

    def _replay_window(self, group, prog_cache: Optional[Dict[Tuple, Any]]
                       = None) -> Tuple[int, bool]:
        """One stacked-rows fused window over consecutive journaled ticks.
        Exactness: pin the touched arenas' columns (K19) after prepare,
        run, verify; a nonzero miss count copies the pin back in place
        (the window's graph keeps the addresses), restores the counters,
        the ledger and the attribution plane, and replays the window tick
        by tick.  Returns (replayed lanes, ran fused)."""
        from orleans_tpu_torch.tensor.fused import FusedTickProgram

        eng = self.engine()
        first_tick = group[0][0]
        T = len(group)
        by_site: Dict[Tuple[str, str], Dict[int, Dict]] = {}
        order: List[Tuple[str, str]] = []
        lanes_total = 0
        for t, (_tick, entries) in enumerate(group):
            pos = -1
            for e in entries:
                site = (e["type"], e["method"])
                if site not in by_site:
                    by_site[site] = {}
                    order.insert(pos + 1, site)
                    pos += 1
                else:
                    pos = order.index(site)
                by_site[site][t] = e
                lanes_total += len(e["keys"])
        if all(len(entries) <= 1 for _, entries in group):
            # no tick sequences two sites: sort the order canonically so
            # windows that merely meet sites in another order share a
            # signature (and a program)
            order.sort()
        sites = []
        stackeds = []
        for site in order:
            per_tick = by_site[site]
            example = next(iter(per_tick.values()))
            m = len(example["keys"])
            keys2d = np.full((T, m), -1, dtype=np.int64)
            mask2d = np.zeros((T, m), dtype=bool)
            for t, e in per_tick.items():
                keys2d[t] = np.asarray(e["keys"], np.int64)
                mask2d[t] = True
            ex_leaves = _skeleton_flatten(example["args"], [])
            skel, _ = _tree_skeleton(example["args"])
            stacked_leaves = []
            for li, ex in enumerate(ex_leaves):
                ex = np.asarray(ex)
                buf = np.zeros((T, *ex.shape), dtype=ex.dtype)
                for t, e in per_tick.items():
                    buf[t] = np.asarray(_skeleton_flatten(e["args"], [])[li])
                stacked_leaves.append(buf)
            args_stacked = _skeleton_unflatten(skel, stacked_leaves)
            if not isinstance(args_stacked, dict):
                # the reserved leaves ride a dict: other arg trees replay
                # tick by tick
                return self._replay_group_per_tick(group), False
            sites.append((site[0], site[1], keys2d, mask2d))
            stackeds.append(dict(args_stacked))
        sig = (T, tuple(
            (tn, m, k2.shape[1],
             tuple(sorted((name, np.shape(lf), np.asarray(lf).dtype.str)
                          for name, lf in st.items())))
            for (tn, m, k2, _mk), st in zip(sites, stackeds)))
        prog = prog_cache.get(sig) if prog_cache is not None else None
        if prog is not None:
            # the same window shape as an earlier one: swap the
            # injections into the cached program's sources
            for src, (_tn, _m, k2, mk) in zip(prog.sources, sites):
                src.keys2d = np.asarray(k2, dtype=np.int64)
                src.mask2d = np.asarray(mk, dtype=bool)
                src.keys = (np.unique(src.keys2d[src.mask2d])
                            if src.mask2d.any()
                            else np.empty(0, dtype=np.int64))
                src.refresh_rows()
        else:
            try:
                prog = FusedTickProgram.replay(eng, sites)
            except KeyError:
                return self._replay_group_per_tick(group), False
            if prog_cache is not None:
                prog_cache[sig] = prog
        statics = [{} for _ in sites]
        for si, s in enumerate(prog.sources):
            stackeds[si]["__rows__"] = s.rows2d
            stackeds[si]["__mask__"] = s.mask2d
        multi = len(sites) > 1
        stacked_arg = stackeds if multi else stackeds[0]
        static_arg = statics if multi else statics[0]
        # prepare BEFORE the pin: resolution can activate keys and grow an
        # arena, which would make the pin unrestorable
        prog.prepare(stacked_arg, static_arg)
        for si, s in enumerate(prog.sources):
            stackeds[si]["__rows__"] = s.rows2d
            stackeds[si]["__mask__"] = s.mask2d
        snapshot = {}
        for n in prog._touched:
            state = eng.arena_for(n).state
            snapshot[n] = dict(zip(state, pin_columns(list(state.values()))))
        counters = (eng.tick_number, eng.messages_processed)
        ledger_state = eng.ledger.snapshot_state()
        attr_state = eng.attribution.snapshot_state()
        eng.tick_number = first_tick  # stamps match the original run
        prog.run(stacked_arg, static_arg)
        if prog.verify() == 0:
            return lanes_total, True
        # not exact (a cold emit destination the hints did not cover, an
        # expansion overflow): roll back and replay tick by tick
        for n, cols in snapshot.items():
            arena = eng.arena_for(n)
            live = arena.state
            pin_columns([cols[c] for c in live],
                        [live[c] for c in live])
            # the window's O(1) use stamp becomes per-row stamps, as the
            # JAX window writes them: the tick-by-tick replay below then
            # overwrites the rows it touches with their (earlier) ticks
            arena.last_use_tick = arena.host_clock()
            arena.fused_use_tick = 0
        eng.tick_number, eng.messages_processed = counters
        eng.ledger.restore_state(ledger_state)
        eng.attribution.restore_state(attr_state)
        return self._replay_group_per_tick(group), False

    def _replay_group_per_tick(self, group) -> int:
        eng = self.engine()
        lanes = 0
        for tick, entries in group:
            eng.tick_number = tick  # stamps match the original run
            for e in entries:
                eng.send_batch(e["type"], e["method"], e["keys"], e["args"])
                lanes += len(e["keys"])
            eng.run_tick()
        return lanes

    def _restore_arena_part(self, name: str, ref: Dict[str, Any],
                            base: bool, store: Optional[Any] = None,
                            replace: bool = False) -> int:
        """Land one manifest entry's arena part.  A FULL part assembles
        every state column at full capacity in numpy (field inits, one
        fancy-index placement per part) and adopts it with one pinned
        upload per column (``adopt_columns``).  A DELTA part concatenates
        its chunks and lands them with one K3 SET per column.  ``store``
        overrides the plane's store (the warm standby); ``replace``
        permits full adoption over a non-empty arena (a standby re-basing
        onto a newer full)."""
        store = store if store is not None else self.store
        got = store.get_blob(ref["meta"])
        if got is None:
            raise RuntimeError(
                f"manifest references missing snapshot blob {ref['meta']} "
                f"(commit-order contract broken)")
        meta_arrays, meta = got
        arena = self.engine().arena_for(name)
        parts = []
        for blob in ref["parts"]:
            got = store.get_blob(blob)
            if got is None:
                raise RuntimeError(
                    f"manifest references missing snapshot blob {blob}")
            parts.append(got[0])
        restored = 0
        if base or ref.get("kind") == "full":
            arena.adopt_layout(meta, meta_arrays["key_of_row"],
                               meta_arrays["last_use_tick"],
                               meta_arrays["shard_next"],
                               init_columns=False, replace=replace)
            capacity = arena.capacity
            part_rows = [np.asarray(p["__rows"], np.int64) for p in parts]
            restored = sum(len(r) for r in part_rows)
            columns: Dict[str, np.ndarray] = {}
            for fname, f in arena.info.state_fields.items():
                dtype = np_dtype(f.dtype)
                col = np.full((capacity, *f.shape), f.init, dtype=dtype)
                for p, rows in zip(parts, part_rows):
                    col[rows] = np.asarray(p[fname], dtype=dtype)
                columns[fname] = col
            last_dev = np.zeros(capacity, dtype=np.int32)
            for p, rows in zip(parts, part_rows):
                last_dev[rows] = np.asarray(p["__last_use_dev"], np.int32)
            arena.adopt_columns(columns, last_dev)
        else:
            # a delta within one generation: rows never moved, so the
            # recorded row ids land exactly
            all_rows = np.concatenate([p["__rows"] for p in parts]) \
                if parts else np.empty(0, np.int64)
            all_keys = np.concatenate([p["__keys"] for p in parts]) \
                if parts else np.empty(0, np.int64)
            arena.adopt_delta(meta, all_rows, all_keys,
                              meta_arrays["live_keys"],
                              meta_arrays["shard_next"],
                              meta_arrays["last_use_tick"])
            if parts:
                columns = {fname: np.concatenate(
                    [np.asarray(p[fname]) for p in parts])
                    for fname in arena.info.state_fields}
                last_dev = np.concatenate(
                    [np.asarray(p["__last_use_dev"]) for p in parts])
                arena.scatter_restore(all_rows, columns, last_dev)
                restored = len(all_rows)
        return restored

    # -- observability ------------------------------------------------------

    def pause_p99_s(self) -> float:
        if not self.pauses:
            return 0.0
        return float(np.percentile(np.asarray(self.pauses), 99))

    def age_ticks(self) -> int:
        """Ticks since the last committed recovery point (the live loss
        window gauge)."""
        if not self.enabled or self._last_ckpt_tick < 0:
            return -1
        return int(self.engine().tick_number - self._last_ckpt_tick)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "enabled": self.enabled,
            "full_snapshots": self.full_snapshots,
            "delta_snapshots": self.delta_snapshots,
            "rows_written": self.rows_written,
            "bytes_written": self.bytes_written,
            "restored_rows": self.restored_rows,
            "last_restore_s": round(self.last_restore_s, 6),
            "last_dirty_rows": self.last_dirty_rows,
            "age_ticks": self.age_ticks(),
            "pause_p99_s": round(self.pause_p99_s(), 6),
            "max_pause_s": round(self.max_pause_s, 6),
            "in_progress": self._active.kind
            if self._active is not None else None,
            "replay_fused_windows": self.replay_fused_windows,
            "replay_fused_lanes": self.replay_fused_lanes,
            "promotions": self.promotions,
            "last_rto_s": round(self.last_rto_s, 6),
            "journal": self.journal.snapshot(),
        }


class StandbyTailer:
    """Warm-standby log shipping over the primary's ``SnapshotStore``.

    A standby engine tails the primary's committed recovery entries
    (fulls and deltas, adopted straight into its arenas) and sealed
    journal segments (staged on the host only: a delta records absolute
    values at its cut, so applying journaled ticks the next delta already
    covers would count them twice).  ``promote()`` then only fences the
    store and replays the staged tail — no full restore inside the outage
    window.  Everything flows through the blobs-first / manifest-last
    order, so every blob a manifest names is readable when the tailer sees
    it; the one race is pruning (the primary deletes superseded blobs
    after a new full), and a missing blob mid-poll resets the tailer,
    whose next poll re-bases onto the newer full."""

    def __init__(self, engine, store: SnapshotStore) -> None:
        self._engine = weakref.ref(engine)
        self.store = store
        self._manifest: Optional[Dict[str, Any]] = None
        self._adopted_seqs: set = set()
        self._adopted_tick = -1
        self._full_seq = -1
        # blob name → (arrays, meta): sealed segments staged on the host,
        # handed to _load_replay_tail as its cache at promotion
        self._staged: Dict[str, Any] = {}
        self._staged_tick = -1
        self._staged_timers: List[Tuple[Any, Any]] = []
        self.polls = 0
        self.adopted_rows = 0
        self.adopted_entries = 0
        self.resets = 0
        self.promoted = False
        self.last_promote_s = 0.0

    def _reset(self) -> None:
        self._adopted_seqs.clear()
        self._staged_timers = []
        self._adopted_tick = -1
        self._full_seq = -1

    def poll(self) -> Dict[str, Any]:
        """One tailing step: adopt recovery entries newer than what this
        standby holds, stage newly sealed journal segments."""
        self.polls += 1
        manifest = self.store.read_manifest()
        if manifest is None:
            return {"adopted_entries": 0, "staged_segments": 0}
        self._manifest = manifest
        plane = self._engine().checkpointer
        rec = manifest.get("recovery") or {}
        entries = [rec["full"]] if rec.get("full") else []
        entries += list(rec.get("deltas") or [])
        adopted = 0
        try:
            if entries and int(entries[0]["seq"]) != self._full_seq:
                # a newer full supersedes everything adopted so far
                self._reset()
                self._full_seq = int(entries[0]["seq"])
            for entry in entries:
                seq = int(entry["seq"])
                if seq in self._adopted_seqs:
                    continue
                is_base = entry is entries[0]
                for name, ref in entry["arenas"].items():
                    self.adopted_rows += plane._restore_arena_part(
                        name, ref, base=is_base, store=self.store,
                        replace=is_base)
                if entry.get("timers"):
                    got = self.store.get_blob(entry["timers"])
                    if got is None:
                        raise RuntimeError(
                            f"standby: timers blob {entry['timers']} "
                            f"pruned mid-poll")
                    self._staged_timers.append(got)
                self._adopted_seqs.add(seq)
                self._adopted_tick = max(self._adopted_tick,
                                         int(entry["tick"]))
                self.adopted_entries += 1
                adopted += 1
        except RuntimeError:
            # the prune race: drop everything, the next poll re-bases
            self._reset()
            self.resets += 1
            return {"adopted_entries": 0, "staged_segments": 0,
                    "reset": True}
        staged = 0
        live_blobs = set()
        for _key, j in (manifest.get("journal") or {}).items():
            for seg in j["segments"]:
                live_blobs.add(seg["blob"])
                if seg["blob"] in self._staged:
                    continue
                got = self.store.get_blob(seg["blob"])
                if got is None:
                    continue  # pruned already: harmless
                self._staged[seg["blob"]] = got
                self._staged_tick = max(self._staged_tick,
                                        int(seg["tick_max"]))
                staged += 1
        for blob in list(self._staged):
            if blob not in live_blobs:
                del self._staged[blob]  # a new full made it dead
        return {"adopted_entries": adopted, "staged_segments": staged}

    def lag_ticks(self) -> int:
        """How far this standby trails the durable horizon, in ticks; -1
        until the first manifest is seen."""
        if self._manifest is None:
            return -1
        rec = self._manifest.get("recovery") or {}
        durable = int(rec.get("tick", -1))
        for _key, j in (self._manifest.get("journal") or {}).items():
            for seg in j["segments"]:
                durable = max(durable, int(seg["tick_max"]))
        held = max(self._adopted_tick, self._staged_tick)
        if durable < 0:
            return 0
        return max(0, durable - held)

    async def promote(self, owner: str = "") -> Dict[str, Any]:
        """Take over the primary's range: fence the store (the old
        primary's next commit raises FencedError), catch up the last
        committed entries, restore the staged timers, fold-replay only the
        un-adopted journal tail, and leave the engine serving at the
        durable horizon.  No terminal full: the cadence re-anchors outside
        the outage window."""
        eng = self._engine()
        plane = eng.checkpointer
        t0 = time.perf_counter()
        plane.attach_store(self.store)
        epoch = plane.acquire_fence(owner or "standby")
        # the final catch-up under the fence: whatever the old primary
        # committed before the fence is adopted or staged here
        self.poll()
        manifest = plane._manifest
        if self._staged_timers:
            for arrays, tmeta in self._staged_timers:
                eng.timers.restore_entry(arrays, tmeta)
            eng.timers.finish_restore(self._adopted_tick)
        replay = plane._load_replay_tail(manifest, self._adopted_tick,
                                         cache=self._staged)
        plane._replaying = True
        try:
            if self._adopted_tick >= 0:
                eng.tick_number = max(eng.tick_number, self._adopted_tick)
            replayed, fused_windows, fused_lanes = \
                plane._fold_replay(replay)
            await eng.flush()
        finally:
            plane._replaying = False
        plane.journal.replayed_lanes += replayed
        mt = (manifest.get("engine") or {}).get("tick_number")
        if mt is not None:
            eng.tick_number = max(eng.tick_number, int(mt))
        # the defer re-anchor's tick bump (see recover)
        eng.tick_number += 1
        plane.restored_rows += self.adopted_rows
        plane.promotions += 1
        self.promoted = True
        self.last_promote_s = time.perf_counter() - t0
        plane.last_rto_s = self.last_promote_s
        return {"promoted": True,
                "fence_epoch": epoch,
                "adopted_tick": self._adopted_tick,
                "adopted_rows": self.adopted_rows,
                "replayed_lanes": replayed,
                "fused_windows": fused_windows,
                "fused_lanes": fused_lanes,
                "seconds": round(self.last_promote_s, 6)}

    def snapshot(self) -> Dict[str, Any]:
        return {"polls": self.polls,
                "adopted_entries": self.adopted_entries,
                "adopted_rows": self.adopted_rows,
                "adopted_tick": self._adopted_tick,
                "staged_segments": len(self._staged),
                "lag_ticks": self.lag_ticks(),
                "resets": self.resets,
                "promoted": self.promoted,
                "last_promote_s": round(self.last_promote_s, 6)}
