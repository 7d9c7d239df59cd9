"""In-process multi-silo test cluster (the port of
``orleans_tpu/testing/cluster.py`` over the in-process transport).

Parity: reference TestingSiloHost (reference: src/OrleansTestingHost/
TestingSiloHost.cs:58 — StartAdditionalSilos :235, KillSilo :334).  The
silos share one event loop, one ``InProcTransport`` with wire fidelity
(every message crosses as codec bytes) and one
``InMemoryMembershipTable``.  Their tensor engines all run on one device:
the card by default, or the CPU when the caller asks (the tests do).
``store_backing`` shares one ``MemoryVectorStore`` backing between the
silos' engines, so rows written back by one silo re-activate with their
state on another.

    cluster = await TestingCluster(n_silos=2, device="cuda").start()
    a = cluster.silos[0]
    a.tensor_engine.send_batch("PresenceGrain", "heartbeat", keys, args)
    await cluster.quiesce_engines()
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable, Dict, List, Optional

from orleans_tpu_torch.config import SiloConfig
from orleans_tpu_torch.runtime.membership import InMemoryMembershipTable
from orleans_tpu_torch.runtime.silo import Silo
from orleans_tpu_torch.runtime.transport import InProcTransport
from orleans_tpu_torch.tensor.persistence import MemoryVectorStore


class TestingCluster:

    __test__ = False  # not a pytest collection target

    def __init__(self, n_silos: int = 2,
                 config_factory: Optional[Callable[[str], SiloConfig]] = None,
                 wire_fidelity: bool = True,
                 silo_setup: Optional[Callable[[Silo], None]] = None,
                 device: Optional[Any] = None,
                 store_backing: Optional[Dict] = None) -> None:
        self.n_initial = n_silos
        self.config_factory = config_factory or self._default_config
        # per-silo wiring hook run before silo.start()
        self.silo_setup = silo_setup
        self.device = device
        self.store_backing = store_backing
        self.fabric = InProcTransport(wire_fidelity=wire_fidelity)
        self.table = InMemoryMembershipTable()
        self.silos: List[Silo] = []
        self._counter = 0

    @staticmethod
    def _default_config(name: str) -> SiloConfig:
        cfg = SiloConfig(name=name)
        # fast liveness for tests (reference: TestingSiloHost liveness
        # config with shortened probe/vote timings)
        cfg.liveness.probe_period = 0.1
        cfg.liveness.probe_timeout = 0.1
        cfg.liveness.num_missed_probes_limit = 2
        cfg.liveness.table_refresh_timeout = 0.2
        cfg.liveness.iam_alive_table_publish = 0.5
        return cfg

    async def start(self) -> "TestingCluster":
        for _ in range(self.n_initial):
            await self.start_additional_silo()
        return self

    async def start_additional_silo(self, name: Optional[str] = None) -> Silo:
        """(reference: TestingSiloHost.StartAdditionalSilos :235)"""
        if name is None:
            self._counter += 1
            name = f"silo{self._counter}"
        store = MemoryVectorStore(self.store_backing) \
            if self.store_backing is not None else None
        silo = Silo(config=self.config_factory(name), fabric=self.fabric,
                    membership_table=self.table, device=self.device,
                    store=store)
        if self.silo_setup is not None:
            self.silo_setup(silo)
        await silo.start()
        self.silos.append(silo)
        await asyncio.sleep(0)  # let membership settle
        return silo

    def kill_silo(self, silo: Silo) -> None:
        """Hard kill — no goodbye, no handoff; peers must detect it
        (reference: TestingSiloHost.KillSilo :334)."""
        silo.kill()
        if silo in self.silos:
            self.silos.remove(silo)

    async def stop_silo(self, silo: Silo) -> None:
        """Graceful single-silo shutdown."""
        await silo.stop()
        if silo in self.silos:
            self.silos.remove(silo)

    async def stop(self) -> None:
        for silo in list(reversed(self.silos)):
            await silo.stop()
        self.silos.clear()

    async def quiesce_engines(self, rounds: int = 300,
                              poll: float = 0.01) -> None:
        """Flush every silo's engine until no engine processes anything
        new — slabs may still be in flight between silos after any one
        engine drains, so stability is observed cluster-wide."""
        last, stable = -1, 0
        for _ in range(rounds):
            for silo in self.silos:
                if silo.tensor_engine is not None:
                    await silo.tensor_engine.flush()
            await asyncio.sleep(poll)
            total = sum(s.tensor_engine.messages_processed
                        for s in self.silos if s.tensor_engine is not None)
            if total == last:
                stable += 1
                if stable >= 3:
                    return
            else:
                stable = 0
            last = total
        raise TimeoutError("tensor data plane did not quiesce")

    async def wait_for_liveness_convergence(self,
                                            timeout: float = 10.0) -> None:
        """Wait until every live silo's view equals exactly the live set
        (killed silos declared dead by every survivor)."""
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            expected = frozenset(s.address for s in self.silos)
            if all(frozenset(s.active_silos()) == expected
                   for s in self.silos):
                return
            if asyncio.get_running_loop().time() > deadline:
                views = [frozenset(s.active_silos()) for s in self.silos]
                raise TimeoutError(
                    f"liveness did not converge: {views} != {expected}")
            await asyncio.sleep(0.05)
