"""Silo-to-silo transport: the in-process fabric (the ``InProcTransport``
and ``BoundTransport`` of ``orleans_tpu/runtime/transport.py``).

Several silos in one process and one event loop (reference analog:
TestingSiloHost's AppDomains, TestingSiloHost.cs:58).  ``wire_fidelity``
pushes every message through the binary codec, encode and decode, so a
slab crosses as the bytes a socket would carry and arrives as fresh
numpy arrays.  Without it the JAX package hands the peer the message
object itself; the port hands it a deep copy of the arguments
(``codec.deep_copy``), since a tensor in them could still be rewritten in
place by its sender.  The TCP transport belongs to a later slice.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Any, Callable, Dict, Optional

from orleans_tpu_torch.codec import default_manager as codec
from orleans_tpu_torch.ids import SiloAddress
from orleans_tpu_torch.runtime.messaging import (
    Direction,
    Message,
    RejectionType,
    ResponseKind,
    is_slab_message,
)


class InProcTransport:
    """Shared in-process fabric: a registry of silo inboxes.  One instance
    is shared by every silo of an in-process cluster; a killed or stopped
    silo detaches, so sends to it fail like a closed socket."""

    def __init__(self, wire_fidelity: bool = True) -> None:
        self._inboxes: Dict[SiloAddress, Callable[[Message], None]] = {}
        self._silos: Dict[SiloAddress, Any] = {}
        self.wire_fidelity = wire_fidelity
        self.messages_carried = 0
        # the codec's work on this fabric: bytes encoded and seconds spent
        # encoding + decoding, all messages and the slab frames alone
        self.bytes_carried = 0
        self.codec_seconds = 0.0
        self.slab_frames_carried = 0
        self.slab_bytes = 0
        self.slab_codec_seconds = 0.0

    def attach(self, silo) -> "BoundTransport":
        self._inboxes[silo.address] = silo.message_center.deliver_local
        self._silos[silo.address] = silo
        return BoundTransport(self, silo.address)

    def detach(self, address: SiloAddress) -> None:
        self._inboxes.pop(address, None)
        self._silos.pop(address, None)

    def send(self, sender: SiloAddress, msg: Message) -> None:
        deliver = self._inboxes.get(msg.target_silo)
        if deliver is None:
            # closed-socket analog: the connection refuses at once, so a
            # request bounces back as a transient rejection (the caller's
            # resend machinery re-addresses) instead of hanging for the
            # whole response timeout; one-ways and responses to a vanished
            # peer have no bounce path and are counted as dropped
            back = self._inboxes.get(sender)
            if back is not None and msg.direction == Direction.REQUEST:
                rejection = msg.create_rejection(
                    RejectionType.TRANSIENT,
                    f"target silo {msg.target_silo} unreachable")
                asyncio.get_running_loop().call_soon(back, rejection)
            else:
                sender_silo = self._silos.get(sender)
                if sender_silo is not None:
                    sender_silo.metrics.undeliverable_dropped += 1
            return
        self.messages_carried += 1
        if self.wire_fidelity:
            t0 = time.perf_counter()
            try:
                data = codec.serialize(msg)
                out = codec.deserialize(data)
            except Exception as exc:  # noqa: BLE001
                # a message that cannot cross the wire must not become a
                # black hole: a response degrades to a stringified error,
                # a request bounces as an unrecoverable rejection
                out = self._degrade(sender, msg, exc)
                if out is None:
                    return
                data = b""
            dt = time.perf_counter() - t0
            self.bytes_carried += len(data)
            self.codec_seconds += dt
            if is_slab_message(msg):
                self.slab_frames_carried += 1
                self.slab_bytes += len(data)
                self.slab_codec_seconds += dt
            msg = out
        else:
            msg = dataclasses.replace(msg, args=codec.deep_copy(msg.args),
                                      result=codec.deep_copy(msg.result))
        # schedule rather than call: one-way send semantics, no reentrant
        # dispatcher stacks
        asyncio.get_running_loop().call_soon(deliver, msg)

    def _degrade(self, sender: SiloAddress, msg: Message,
                 exc: Exception) -> Optional[Message]:
        if msg.direction == Direction.RESPONSE:
            return codec.deserialize(codec.serialize(dataclasses.replace(
                msg, response_kind=ResponseKind.ERROR,
                result=RuntimeError(
                    f"response not serializable ({exc!r}); original "
                    f"result/error: {msg.result!r}"))))
        back = self._inboxes.get(sender)
        if back is not None and msg.direction == Direction.REQUEST:
            asyncio.get_running_loop().call_soon(back, msg.create_rejection(
                RejectionType.UNRECOVERABLE,
                f"unserializable request: {exc!r}"))
        return None


class BoundTransport:
    """A silo's handle on the shared fabric (what MessageCenter calls)."""

    def __init__(self, fabric: InProcTransport,
                 address: SiloAddress) -> None:
        self.fabric = fabric
        self.address = address

    def send(self, msg: Message) -> None:
        self.fabric.send(self.address, msg)

    def close(self) -> None:
        self.fabric.detach(self.address)
