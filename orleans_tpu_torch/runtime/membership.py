"""Membership: table-based liveness with probes, suspect votes, and gossip
(a copy of ``orleans_tpu/runtime/membership.py`` without the clock probe,
which feeds the timeline plane of a later slice).

Parity: the reference's MembershipOracle protocol (reference:
src/OrleansRuntime/MembershipService/MembershipOracle.cs:35 — Start :79,
BecomeActive :146, probe timer :178, OnProbeOtherSilosTimer :775,
TryToSuspectOrKill :915, gossip :309) over a pluggable CAS table
(reference: IMembershipTable.cs — MembershipEntry :257, TableVersion :133,
SuspectTimes :273-283; InMemoryMembershipTable.cs:33;
GrainBasedMembershipTable.cs:32).

The exact state machine is kept: a silo writes itself JOINING then ACTIVE;
every silo probes its ring successors; ``num_missed_probes_limit`` missed
probes trigger a suspect vote appended to the victim's table entry via CAS;
``num_votes_for_death`` fresh votes declare it DEAD (version bump); gossip
is a hint to re-read the table, never trusted as data.  Silo restarts get a
new generation, so the old incarnation is declared dead on join
(DetectNodeMigration, MembershipOracle.cs:111).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field, replace
from enum import Enum
from typing import Dict, List, Optional, Tuple

from orleans_tpu_torch.config import LivenessConfig
from orleans_tpu_torch.ids import SiloAddress


class SiloStatus(Enum):
    """(reference: SiloStatus enum)"""

    JOINING = "joining"
    ACTIVE = "active"
    SHUTTING_DOWN = "shutting_down"
    DEAD = "dead"


@dataclass
class MembershipEntry:
    """(reference: IMembershipTable.cs MembershipEntry :257)"""

    silo: SiloAddress
    status: SiloStatus
    # (suspecting silo, vote time) — votes expire
    # (reference: GlobalConfiguration DeathVoteExpirationTimeout :161)
    suspect_times: List[Tuple[SiloAddress, float]] = field(default_factory=list)
    iam_alive_time: float = 0.0
    start_time: float = 0.0
    # nonzero when this silo runs a client gateway — the membership table
    # doubles as the gateway registry (reference: MembershipEntry.ProxyPort,
    # consumed by AzureGatewayListProvider.cs:35)
    proxy_port: int = 0
    # False for transient/observer members (the admin CLI): they carry NO
    # grain placements and NO ring ranges — the nearest reference analog
    # is a client, which never joins membership at all
    can_host: bool = True

    def fresh_votes(self, now: float, expiration: float
                    ) -> List[Tuple[SiloAddress, float]]:
        return [(s, t) for s, t in self.suspect_times
                if now - t < expiration]


class CasConflictError(Exception):
    """Etag/version mismatch on a table write — re-read and retry
    (reference: CAS discipline of IMembershipTable writes)."""


class InMemoryMembershipTable:
    """Shared-process table (reference: InMemoryMembershipTable.cs:33,
    wrapped by GrainBasedMembershipTable for the dev 'table is a grain on
    the primary silo' mode).  One instance is shared by all silos of an
    in-process cluster; a real deployment plugs an external store with the
    same contract."""

    def __init__(self) -> None:
        self._entries: Dict[SiloAddress, Tuple[MembershipEntry, int]] = {}
        self._version = 0  # TableVersion (reference: IMembershipTable.cs:133)
        self.write_count = 0

    async def read_all(self) -> Tuple[Dict[SiloAddress, Tuple[MembershipEntry, int]], int]:
        # deep-ish copy so callers can't mutate the table in place
        snap = {s: (replace(e, suspect_times=list(e.suspect_times)), etag)
                for s, (e, etag) in self._entries.items()}
        return snap, self._version

    async def insert_row(self, entry: MembershipEntry,
                         table_version: int) -> None:
        if table_version != self._version:
            raise CasConflictError("table version moved")
        if entry.silo in self._entries:
            raise CasConflictError("row exists")
        self._entries[entry.silo] = (replace(
            entry, suspect_times=list(entry.suspect_times)), 0)
        self._version += 1
        self.write_count += 1

    async def update_row(self, entry: MembershipEntry, etag: int,
                         table_version: int) -> None:
        if table_version != self._version:
            raise CasConflictError("table version moved")
        existing = self._entries.get(entry.silo)
        if existing is None or existing[1] != etag:
            raise CasConflictError("row etag moved")
        self._entries[entry.silo] = (replace(
            entry, suspect_times=list(entry.suspect_times)), etag + 1)
        self._version += 1
        self.write_count += 1

    async def update_iam_alive(self, silo: SiloAddress, when: float) -> None:
        """Heartbeat column write — no CAS needed
        (reference: IMembershipTable.UpdateIAmAlive)."""
        existing = self._entries.get(silo)
        if existing is not None:
            entry, etag = existing
            entry.iam_alive_time = when


class MembershipOracle:
    """Per-silo liveness agent + the silo's membership view
    (reference: MembershipOracle.cs:35 + MembershipOracleData)."""

    def __init__(self, silo, table: InMemoryMembershipTable,
                 config: Optional[LivenessConfig] = None) -> None:
        self.silo = silo
        self.table = table
        self.config = config or LivenessConfig()
        self.my_status = SiloStatus.JOINING
        # local view, refreshed from the table
        self.view: Dict[SiloAddress, SiloStatus] = {}
        # silo → can_host flag from its membership entry
        self.hosting: Dict[SiloAddress, bool] = {}
        self._known_dead: set = set()
        self._missed_probes: Dict[SiloAddress, int] = {}
        # fast-suspect: victims currently being probed out-of-band (a
        # suspicion notification arrived) — dedup guard so a gossip
        # storm cannot pile concurrent probes on one victim
        self._fast_probing: set = set()
        self._tasks: List[asyncio.Task] = []
        self._running = False
        self.logger = silo.logger.child("membership")

        # system-target surface for remote probes/gossip
        silo.register_system_target("membership", _MembershipTarget(self))

    # ================= lifecycle ==========================================

    async def start(self) -> None:
        """(reference: MembershipOracle.Start :79 + BecomeActive :146)"""
        now = time.time()
        await self._cleanup_old_incarnations()
        await self._write_myself(SiloStatus.JOINING, now)
        await self._write_myself(SiloStatus.ACTIVE, now)
        self.my_status = SiloStatus.ACTIVE
        await self.refresh_view()
        self._running = True
        loop = asyncio.get_running_loop()
        self._tasks = [
            loop.create_task(self._probe_loop()),
            loop.create_task(self._iam_alive_loop()),
            loop.create_task(self._table_refresh_loop()),
        ]
        await self.gossip()

    async def leave(self) -> None:
        """Graceful exit (reference: MembershipOracle.ShutDown/Stop)."""
        self._running = False
        for t in self._tasks:
            t.cancel()
        try:
            await self._write_myself(SiloStatus.SHUTTING_DOWN, time.time())
            await self._write_myself(SiloStatus.DEAD, time.time())
        except CasConflictError:
            pass
        self.my_status = SiloStatus.DEAD
        await self.gossip()

    def kill(self) -> None:
        """Crash: no table writes; peers must detect via probes
        (reference: TestingSiloHost.KillSilo hard-kill semantics)."""
        self._running = False
        for t in self._tasks:
            t.cancel()
        self.my_status = SiloStatus.DEAD

    # ================= view ===============================================

    def active_silos(self) -> List[SiloAddress]:
        out = [s for s, st in self.view.items() if st == SiloStatus.ACTIVE]
        if self.my_status == SiloStatus.ACTIVE \
                and self.silo.address not in out:
            out.append(self.silo.address)
        return out

    def is_alive(self, silo: SiloAddress) -> bool:
        if silo == self.silo.address:
            return self.my_status == SiloStatus.ACTIVE
        return self.view.get(silo) in (SiloStatus.ACTIVE, SiloStatus.JOINING)

    async def refresh_view(self) -> None:
        """Re-read the table and fan out changes — gossip is only a hint
        (reference: SiloStatusChangeNotification :309 'recipients re-read
        the table, not trusting payload')."""
        snapshot, _version = await self.table.read_all()
        if (self._running and self.my_status == SiloStatus.ACTIVE
                and self.silo.address not in snapshot):
            # the table lost my registration — the realistic case is a
            # table-service restart from an empty store.  Re-register
            # rather than wedge: update_iam_alive silently no-ops on a
            # missing row, so without this a restarted blank table would
            # never re-learn the live silos (and new joiners would see
            # an empty cluster).  Stale held etags are irrelevant here:
            # _write_myself re-reads before every attempt.
            self.logger.warn(
                f"{self.silo.address}: own ACTIVE row missing from the "
                f"membership table (table restarted empty?) — "
                f"re-registering", code=2915)
            await self._write_myself(SiloStatus.ACTIVE, time.time())
            snapshot, _version = await self.table.read_all()
        new_view: Dict[SiloAddress, SiloStatus] = {}
        new_hosting: Dict[SiloAddress, bool] = {}
        for addr, (entry, _etag) in snapshot.items():
            if addr == self.silo.address:
                # self-death check: if peers declared me dead I must stop
                # serving immediately — continuing would be split brain
                # (reference: MembershipOracle.KillMyself on own DEAD row)
                if (entry.status == SiloStatus.DEAD
                        and self.my_status != SiloStatus.DEAD):
                    self.logger.error(
                        f"{self.silo.address} found itself declared DEAD "
                        f"in the membership table — killing myself")
                    self.my_status = SiloStatus.DEAD
                    self.silo.kill()
                    return
                continue
            new_view[addr] = entry.status
            new_hosting[addr] = getattr(entry, "can_host", True)
        old_view = self.view
        self.view = new_view
        self.hosting = new_hosting
        for addr, status in new_view.items():
            if status == SiloStatus.ACTIVE and old_view.get(addr) != status \
                    and new_hosting.get(addr, True):
                # non-hosting members never take ring ranges (directory,
                # reminders, stream queues stay on real hosts)
                self.silo.ring.add_silo(addr)
            if status == SiloStatus.DEAD and addr not in self._known_dead:
                self._known_dead.add(addr)
                self.silo.on_silo_dead(addr)

    # ================= table writes =======================================

    async def _cleanup_old_incarnations(self) -> None:
        """Declare dead any previous incarnation of my endpoint
        (reference: DetectNodeMigration, MembershipOracle.cs:111)."""
        for _ in range(5):
            snapshot, version = await self.table.read_all()
            stale = [(e, etag) for s, (e, etag) in snapshot.items()
                     if s.matches(self.silo.address)
                     and s.generation < self.silo.address.generation
                     and e.status != SiloStatus.DEAD]
            if not stale:
                return
            try:
                for entry, etag in stale:
                    entry.status = SiloStatus.DEAD
                    await self.table.update_row(entry, etag, version)
                    _, version = await self.table.read_all()
                return
            except CasConflictError:
                await asyncio.sleep(0)

    async def _write_myself(self, status: SiloStatus, now: float) -> None:
        for _ in range(10):
            snapshot, version = await self.table.read_all()
            existing = snapshot.get(self.silo.address)
            try:
                if existing is None:
                    # the port's silos host grains and run no gateway yet
                    await self.table.insert_row(MembershipEntry(
                        silo=self.silo.address, status=status,
                        iam_alive_time=now, start_time=now), version)
                else:
                    entry, etag = existing
                    entry.status = status
                    await self.table.update_row(entry, etag, version)
                return
            except CasConflictError:
                await asyncio.sleep(0)
        raise CasConflictError(f"could not write {status} for {self.silo.address}")

    # ================= probing ============================================

    def _probe_targets(self) -> List[SiloAddress]:
        """Ring successors to probe (reference: UpdateListOfProbedSilos —
        NumProbedSilos clockwise neighbors on the ring)."""
        others = sorted((s for s in self.view
                         if self.view[s] == SiloStatus.ACTIVE),
                        key=lambda s: s.ring_hash())
        if not others:
            return []
        my_hash = self.silo.address.ring_hash()
        after = [s for s in others if s.ring_hash() > my_hash]
        ordered = after + [s for s in others if s.ring_hash() <= my_hash]
        return ordered[: self.config.num_probed_silos]

    async def _probe_loop(self) -> None:
        """(reference: OnProbeOtherSilosTimer :775)"""
        try:
            while self._running:
                await asyncio.sleep(self.config.probe_period)
                targets = self._probe_targets()
                await asyncio.gather(*(self._probe_one(t) for t in targets),
                                     return_exceptions=True)
        except asyncio.CancelledError:
            pass

    async def _probe_one(self, target: SiloAddress) -> None:
        try:
            alive = await self.silo.system_rpc(
                target, "membership", "ping", (self.silo.address,),
                timeout=self.config.probe_timeout)
            # ping answers False when the target is not ACTIVE (e.g. already
            # shutting down) — a reply alone is not proof of liveness
            if not alive:
                raise RuntimeError(f"{target} answered not-active")
            self._missed_probes[target] = 0
        except Exception:
            missed = self._missed_probes.get(target, 0) + 1
            self._missed_probes[target] = missed
            if missed >= self.config.num_missed_probes_limit:
                await self.try_suspect_or_kill(target)

    async def try_suspect_or_kill(self, victim: SiloAddress) -> None:
        """(reference: MembershipOracle.TryToSuspectOrKill :915)"""
        now = time.time()
        for _ in range(5):
            snapshot, version = await self.table.read_all()
            row = snapshot.get(victim)
            if row is None:
                return
            entry, etag = row
            if entry.status == SiloStatus.DEAD:
                await self.refresh_view()
                return
            votes = entry.fresh_votes(now, self.config.death_vote_expiration)
            new_vote = not any(s == self.silo.address for s, _ in votes)
            if new_vote:
                votes.append((self.silo.address, now))
            try:
                if len(votes) >= self.config.num_votes_for_death \
                        or len(self.active_silos()) <= 2:
                    # enough votes (or tiny cluster) → declare dead
                    entry.status = SiloStatus.DEAD
                    entry.suspect_times = votes
                    await self.table.update_row(entry, etag, version)
                    self.logger.warn(
                        f"declared {victim} DEAD ({len(votes)} votes)")
                    await self.refresh_view()
                    await self.gossip()
                else:
                    entry.suspect_times = votes
                    await self.table.update_row(entry, etag, version)
                    self.logger.warn(f"suspected {victim} "
                                     f"({len(votes)} votes)")
                    await self.refresh_view()
                    await self.gossip()
                    if self.config.fast_suspect and new_vote:
                        # fast-suspect: push the suspicion to peers so
                        # they probe the victim NOW and vote — quorum
                        # converges within ~one probe timeout instead
                        # of waiting every voter's own probe round
                        await self._gossip_suspicion(victim)
                return
            except CasConflictError:
                await asyncio.sleep(0)

    async def _gossip_suspicion(self, victim: SiloAddress) -> None:
        """Fan the suspicion out to every active peer (fast-suspect
        path).  Gossip is still only a HINT: recipients probe the
        victim themselves and vote through the same CAS table protocol
        — no peer ever trusts the payload as a death verdict."""
        for peer in list(self.view):
            if peer == victim:
                continue
            if self.view.get(peer) == SiloStatus.ACTIVE:
                try:
                    await self.silo.system_rpc(
                        peer, "membership", "notify_suspected", (victim,),
                        timeout=self.config.gossip_timeout)
                except Exception:
                    pass

    async def confirm_suspicion(self, victim: SiloAddress) -> None:
        """Receiving half of fast-suspect: a peer suspects ``victim`` —
        probe it immediately (out of band of the probe loop) and add
        our vote if the probe fails."""
        if (not self._running or not self.config.fast_suspect
                or victim == self.silo.address
                or victim in self._fast_probing):
            return
        self._fast_probing.add(victim)
        try:
            try:
                alive = await self.silo.system_rpc(
                    victim, "membership", "ping", (self.silo.address,),
                    timeout=self.config.probe_timeout)
            except Exception:
                alive = False
            if not alive:
                await self.try_suspect_or_kill(victim)
        finally:
            self._fast_probing.discard(victim)

    # ================= heartbeats + refresh ===============================

    async def _iam_alive_loop(self) -> None:
        """(reference: IAmAlive timer :195).  A TRANSIENT table outage
        (networked backend unreachable, CAS store restarting) must not
        kill the loop — a dead heartbeat loop gets a healthy silo
        declared dead as soon as peers' vote windows elapse."""
        try:
            while self._running:
                await asyncio.sleep(self.config.iam_alive_table_publish)
                try:
                    await self.table.update_iam_alive(self.silo.address,
                                                      time.time())
                except Exception as exc:  # noqa: BLE001 — retry next beat
                    self.logger.warn(
                        f"IAmAlive table write failed ({exc!r}); retrying "
                        f"next period", code=2501)
        except asyncio.CancelledError:
            pass

    async def _table_refresh_loop(self) -> None:
        try:
            while self._running:
                await asyncio.sleep(self.config.table_refresh_timeout)
                try:
                    await self.refresh_view()
                except Exception as exc:  # noqa: BLE001 — keep last view,
                    # retry next period (reference: table read failures are
                    # logged, the oracle keeps operating on its last view)
                    self.logger.warn(
                        f"membership table refresh failed ({exc!r}); "
                        f"keeping last view", code=2502)
        except asyncio.CancelledError:
            pass

    # ================= gossip =============================================

    async def gossip(self) -> None:
        """Hint every active peer to re-read the table
        (reference: GossipMyStatus :159 / SiloStatusChangeNotification)."""
        for peer in list(self.view):
            if self.view.get(peer) in (SiloStatus.ACTIVE, SiloStatus.JOINING):
                try:
                    await self.silo.system_rpc(
                        peer, "membership", "notify_table_changed", (),
                        timeout=self.config.gossip_timeout)
                except Exception:
                    pass


class _MembershipTarget:
    """System-target surface (reference: MembershipOracle as SystemTarget
    with well-known id, Constants.cs membership oracle=15)."""

    def __init__(self, oracle: MembershipOracle) -> None:
        self.oracle = oracle

    async def ping(self, from_silo: SiloAddress) -> bool:
        """(reference: probe Ping messages, Categories.Ping)"""
        return self.oracle.my_status == SiloStatus.ACTIVE

    async def notify_table_changed(self) -> None:
        await self.oracle.refresh_view()

    async def notify_suspected(self, victim: SiloAddress) -> None:
        """(fast-suspect hint: probe the victim now, vote if it fails)"""
        await self.oracle.confirm_suspicion(victim)
