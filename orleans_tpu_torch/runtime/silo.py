"""Silo: the vector-plane half of ``orleans_tpu/runtime/silo.py``.

Parity: reference Silo (reference: src/OrleansRuntime/Silo.cs:59 —
constructor wiring :151-337, startup :414-577, graceful stop :642-770,
FastKill :776, system targets :339).  A silo is one asyncio event loop's
worth of control plane plus one tensor engine on the card; several silos
may share a process, a loop and a card (the in-process test cluster,
``testing/cluster.py``).

The constructor keeps the JAX silo's order (silo.py:101-375) without the
planes of later slices: no catalog, directory, gateway, RPC coalescer or
fabric, reminders, rebalancer, spans, metrics registry or resilience
plane.  What it builds: the ring, the message center, the runtime client,
the dispatcher, the membership oracle, the tensor engine (on the card
unless the caller asks for the CPU) and, in a cluster, the vector router
registered as the ``vector_router`` system target — or
``HandoffFenceStub`` on a silo without an engine.
"""

from __future__ import annotations

import asyncio
import uuid
from enum import Enum
from typing import Any, Dict, List, Optional

from orleans_tpu_torch.config import SiloConfig
from orleans_tpu_torch.ids import GrainId, SiloAddress, SystemTargetCodes
from orleans_tpu_torch.runtime.dispatcher import Dispatcher
from orleans_tpu_torch.runtime.messaging import (
    Category,
    Direction,
    Message,
    MessageCenter,
    ResponseKind,
)
from orleans_tpu_torch.runtime.ring import VirtualBucketsRing
from orleans_tpu_torch.runtime.runtime_client import (
    CallbackData,
    InsideRuntimeClient,
)
from orleans_tpu_torch.stats import SiloMetrics
from orleans_tpu_torch.tracing import TraceLogger


class SiloStatus(Enum):
    """(reference: SystemStatus.cs / SiloStatus)"""

    CREATED = "created"
    JOINING = "joining"
    ACTIVE = "active"
    SHUTTING_DOWN = "shutting_down"
    STOPPING = "stopping"
    DEAD = "dead"


_SYSTEM_TARGET_CODES: Dict[str, int] = {
    "membership": int(SystemTargetCodes.MEMBERSHIP_ORACLE),
    "vector_router": int(SystemTargetCodes.VECTOR_ROUTER),
}
_CODE_TO_NAME = {v: k for k, v in _SYSTEM_TARGET_CODES.items()}


class Silo:
    """(reference: Silo.cs:59)"""

    def __init__(self, config: Optional[SiloConfig] = None,
                 name: str = "silo", port: int = 0, fabric=None,
                 membership_table=None, device: Optional[Any] = None,
                 store: Optional[Any] = None) -> None:
        self.config = config or SiloConfig(name=name)
        self.name = self.config.name if config else name
        self.address = SiloAddress.new_local(host=self.name, port=port)
        self.status = SiloStatus.CREATED
        self.logger = TraceLogger(f"silo.{self.name}")
        self.metrics = SiloMetrics()

        # construction order mirrors reference Silo ctor :151-337
        self.ring = VirtualBucketsRing(
            self.address, self.config.directory.buckets_per_silo)
        self.message_center = MessageCenter(self.address)
        self.message_center.metrics = self.metrics
        self.runtime_client = InsideRuntimeClient(self)
        self.runtime_client.response_timeout = \
            self.config.messaging.response_timeout
        self.dispatcher = Dispatcher(self)
        self.max_forward_count = self.config.messaging.max_forward_count
        self.message_center.dispatcher = self.dispatcher

        # system targets (reference: Silo.CreateSystemTargets :339)
        self.system_targets: Dict[str, Any] = {}
        # identity for calls made from non-grain contexts attached to this
        # silo (reference: client GrainId)
        self.client_grain_id = GrainId.client(uuid.uuid4())

        # cluster fabric + membership (single-silo when both are None: the
        # ring is the membership view)
        self._fabric = fabric
        self._bound_transport = None
        self.membership_oracle = None
        if membership_table is not None:
            from orleans_tpu_torch.runtime.membership import MembershipOracle
            self.membership_oracle = MembershipOracle(
                self, membership_table, self.config.liveness)

        # membership-driven ring changes: the handoff runs first, then the
        # router's fence (subscribed below) broadcasts its release
        self.ring.subscribe(lambda *_: self._on_ring_changed())

        # the data plane: a tensor engine on the card unless the caller
        # asks for the CPU; without a card a CUDA silo raises here
        self.tensor_engine = None
        if self.config.tensor.enabled:
            from orleans_tpu_torch.tensor.engine import TensorEngine
            self.tensor_engine = TensorEngine(
                self.config.tensor, device=device,
                metrics=self.config.metrics, store=store, silo=self)
        # cross-silo vector data plane: clustered silos partition vector
        # batches by ring owner and ship remote partitions as slabs
        self.vector_router = None
        if self.tensor_engine is not None and fabric is not None:
            from orleans_tpu_torch.tensor.router import VectorRouter
            self.vector_router = VectorRouter(self)
            self.register_system_target("vector_router", self.vector_router)
        elif fabric is not None:
            # an engine-less clustered silo still releases its peers'
            # handoff fences (it owns no rows)
            from orleans_tpu_torch.tensor.router import HandoffFenceStub
            self.register_system_target("vector_router",
                                        HandoffFenceStub(self))

    # ================= lifecycle (reference: Silo.cs :414,:642) ============

    async def start(self) -> None:
        self.status = SiloStatus.JOINING
        if self._fabric is not None:
            self._bound_transport = self._fabric.attach(self)
            self.message_center.transport = self._bound_transport
        if self.membership_oracle is not None:
            await self.membership_oracle.start()
        if self.tensor_engine is not None:
            self.tensor_engine.start()
        self.status = SiloStatus.ACTIVE
        self.logger.info(f"silo {self.address} active")

    async def stop(self, graceful: bool = True) -> None:
        """(reference: Silo.Terminate :642-770 graceful / FastKill :776).
        A graceful stop drains the engine and writes every row back
        through its store BEFORE the membership goodbye, so a peer that
        re-homes our keys reads their final state on first touch."""
        self.status = SiloStatus.SHUTTING_DOWN if graceful \
            else SiloStatus.STOPPING
        if self.tensor_engine is not None:
            await self.tensor_engine.stop(drain=graceful)
            if graceful and self.tensor_engine.store is not None:
                await self.tensor_engine.checkpoint()
        if graceful and self.membership_oracle is not None:
            await self.membership_oracle.leave()
        if self._bound_transport is not None:
            self._bound_transport.close()
        self.status = SiloStatus.DEAD

    def kill(self) -> None:
        """Hard kill: no drain, no write-back, no goodbye (reference:
        Silo.FastKill :776; TestingSiloHost.KillSilo).  The engine's loop
        ends with whatever it had queued."""
        self.status = SiloStatus.DEAD
        if self.membership_oracle is not None:
            self.membership_oracle.kill()
        if self._bound_transport is not None:
            self._bound_transport.close()
        if self.tensor_engine is not None:
            self.tensor_engine.halt()

    # ================= membership view =====================================

    def active_silos(self) -> List[SiloAddress]:
        if self.membership_oracle is not None:
            return self.membership_oracle.active_silos()
        return self.ring.members

    def is_silo_alive(self, addr: SiloAddress) -> bool:
        if self.membership_oracle is not None:
            return self.membership_oracle.is_alive(addr)
        return addr in self.ring.members

    def on_silo_dead(self, addr: SiloAddress) -> None:
        """Fan-out of a death notification (reference: Silo.cs:364-376)."""
        self.ring.remove_silo(addr)
        self.runtime_client.break_outstanding_messages_to_dead_silo(addr)

    def _on_ring_changed(self) -> None:
        if self.status != SiloStatus.ACTIVE:
            return
        if self.vector_router is not None:
            self.vector_router.on_ring_changed()

    # ================= system targets ======================================

    def register_system_target(self, name: str, instance: Any) -> None:
        self.system_targets[name] = instance

    async def system_rpc(self, target_silo: SiloAddress, target_name: str,
                         method: str, args: tuple,
                         timeout: Optional[float] = None) -> Any:
        """Invoke a system target on any silo (reference: system-target
        GrainReferences)."""
        if target_silo == self.address:
            st = self.system_targets[target_name]
            return await getattr(st, method)(*args)
        loop = asyncio.get_running_loop()
        msg = Message(
            category=Category.SYSTEM,
            direction=Direction.REQUEST,
            sending_silo=self.address,
            sending_grain=self.client_grain_id,
            target_silo=target_silo,
            target_grain=GrainId.system_target(
                _SYSTEM_TARGET_CODES[target_name]),
            method_name=method,
            args=args,
        )
        future: asyncio.Future = loop.create_future()
        cb = CallbackData(future=future, message=msg)
        t = timeout if timeout is not None \
            else self.runtime_client.response_timeout
        cb.timeout_handle = loop.call_later(
            t, self.runtime_client._on_timeout, msg.id)
        self.runtime_client.callbacks[msg.id] = cb
        self.message_center.send_message(msg)
        return await future

    def invoke_system_target(self, msg: Message) -> None:
        """Dispatcher entry for inbound system-target messages."""
        name = _CODE_TO_NAME.get(msg.target_grain.type_code)
        st = self.system_targets.get(name) if name else None

        async def run() -> None:
            try:
                if st is None:
                    raise KeyError(
                        f"no system target {name!r} on {self.address}")
                result = await getattr(st, msg.method_name)(*msg.args)
                if msg.direction != Direction.ONE_WAY:
                    self.message_center.send_message(
                        msg.create_response(result))
            except Exception as exc:  # noqa: BLE001
                if msg.direction != Direction.ONE_WAY:
                    self.message_center.send_message(
                        msg.create_response(exc, ResponseKind.ERROR))
                else:
                    # a one-way system call has no caller to tell: log it,
                    # or a slab whose handler raises vanishes
                    self.logger.warn(
                        f"one-way system call {name}.{msg.method_name} "
                        f"failed: {exc!r}", code=2804, exc_info=True)

        asyncio.get_running_loop().create_task(run())
