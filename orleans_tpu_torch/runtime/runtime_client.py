"""In-silo RPC endpoint: request/response correlation (the half of
``orleans_tpu/runtime/runtime_client.py`` the clustered vector data plane
needs).

Parity: reference InsideRuntimeClient (reference: src/OrleansRuntime/Core/
InsideGrainClient.cs:48 — SendRequest :112, callbacks dict :57,
ReceiveResponse :469, BreakOutstandingMessagesToDeadSilo :754) and
CallbackData's timeout (reference: CallbackData.cs:42,:97).  The system
RPCs between silos (``Silo.system_rpc``) register here, and a vector
grain's call goes to the tensor engine (``send_one``) under the same
response timeout.  Host-grain invocation, the transparent resend with
re-addressing and the batched RPC fastpath belong to a later slice: a
rejection fails its caller.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from orleans_tpu_torch.core.grain import MethodInfo
from orleans_tpu_torch.ids import GrainId, SiloAddress
from orleans_tpu_torch.runtime.messaging import (
    Message,
    RejectionType,
    ResponseKind,
)


class RequestTimeoutError(asyncio.TimeoutError):
    """(reference: TimeoutException thrown by CallbackData.OnTimeout)"""


class RejectionError(Exception):
    def __init__(self, rejection: RejectionType, info: str):
        super().__init__(f"{rejection.name}: {info}")
        self.rejection = rejection
        self.info = info

    def __reduce__(self):
        # responses carrying this exception must survive the wire codec
        return (RejectionError, (self.rejection, self.info))


@dataclass
class CallbackData:
    """(reference: CallbackData.cs:42)"""

    future: asyncio.Future
    message: Message
    timeout_handle: Any = None


class InsideRuntimeClient:
    """One per silo."""

    DEFAULT_RESPONSE_TIMEOUT = 30.0  # (reference: ResponseTimeout default)

    def __init__(self, silo) -> None:
        self.silo = silo
        self.callbacks: Dict[int, CallbackData] = {}
        self.response_timeout = self.DEFAULT_RESPONSE_TIMEOUT

    def send_request(self, target_grain: GrainId, method: MethodInfo,
                     args: Tuple[Any, ...],
                     timeout: Optional[float] = None
                     ) -> Optional[asyncio.Future]:
        """A vector grain's call (reference: InsideGrainClient.SendRequest
        :112): routed into the tick machine, under the response-timeout
        discipline of host-path calls.  Returns the response future, or
        None for a one-way method."""
        if not method.batched:
            raise NotImplementedError(
                f"{method.name}: host-grain calls belong to a later slice "
                f"of the port (catalog, directory, activations)")
        if self.silo.tensor_engine is None:
            raise RuntimeError(
                f"vector grain call {method.name} but the silo has no "
                f"tensor engine")
        fut = self.silo.tensor_engine.send_one(target_grain, method, args)
        if fut is not None:
            t = timeout if timeout is not None else self.response_timeout
            handle = asyncio.get_running_loop().call_later(
                t, lambda: fut.done() or fut.set_exception(
                    RequestTimeoutError(
                        f"vector call {method.name} timed out")))
            fut.add_done_callback(lambda _f: handle.cancel())
        return fut

    def _on_timeout(self, message_id: int) -> None:
        """(reference: CallbackData.OnTimeout :97)"""
        cb = self.callbacks.pop(message_id, None)
        if cb is None:
            return
        self.silo.metrics.requests_timed_out += 1
        if not cb.future.done():
            cb.future.set_exception(RequestTimeoutError(
                f"request {cb.message} timed out after "
                f"{self.response_timeout}s"))

    def receive_response(self, msg: Message) -> None:
        """(reference: InsideGrainClient.ReceiveResponse :469)"""
        cb = self.callbacks.pop(msg.id, None)
        if cb is None:
            return  # late response after timeout — drop
        if cb.timeout_handle is not None:
            cb.timeout_handle.cancel()
        if cb.future.done():
            return
        if msg.response_kind == ResponseKind.REJECTION:
            cb.future.set_exception(RejectionError(
                msg.rejection_type or RejectionType.UNRECOVERABLE,
                msg.rejection_info))
        elif msg.response_kind == ResponseKind.ERROR:
            exc = msg.result if isinstance(msg.result, BaseException) \
                else RuntimeError(str(msg.result))
            cb.future.set_exception(exc)
        else:
            cb.future.set_result(msg.result)

    def break_outstanding_messages_to_dead_silo(self,
                                                silo: SiloAddress) -> None:
        """Fail pending callbacks targeted at a dead silo (reference:
        InsideGrainClient.BreakOutstandingMessagesToDeadSilo :754)."""
        broken = [cb for cb in self.callbacks.values()
                  if cb.message.target_silo == silo]
        for cb in broken:
            self.receive_response(cb.message.create_rejection(
                RejectionType.TRANSIENT,
                f"target silo {silo} declared dead"))
