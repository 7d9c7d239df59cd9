"""Device resolution and the card report.

The port runs on the card unless the caller asks for the CPU: ``None``
means ``"cuda"``, and a CUDA request on a machine without a usable card
raises instead of carrying on on the CPU.  Also the host↔device
plumbing every plane shares: pow2 padding of index vectors, pinned
uploads and a one-wait fetch.
"""

from __future__ import annotations

import subprocess
from typing import Dict, Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``; ``cuda`` without an available card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "orleans_tpu_torch: CUDA requested but torch.cuda.is_available()"
            " is False; pass device='cpu' explicitly to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def card_report() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit``), one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def pow2_pad(rows: np.ndarray, fill: int) -> np.ndarray:
    """Pad an index vector to the next power of two with ``fill`` (the
    JAX package's padding of data-dependent index vectors; the timers
    plane's harvest width, and so the engine's message count, follows
    it)."""
    pad = np.full(1 << max(0, len(rows) - 1).bit_length(), fill, np.int32)
    pad[:len(rows)] = rows
    return pad


def host_upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``, through pinned memory on a card (a
    copy from pageable memory stalls the host behind the queued
    kernels)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def fetch_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Device tensors to host numpy with one wait: every copy goes into
    pinned memory on the current stream, after every kernel enqueued
    there (the ticks before a write-back), then the stream is waited on
    once."""
    out: Dict[str, np.ndarray] = {}
    stream = None
    for name, t in tensors.items():
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            stream = torch.cuda.current_stream(t.device)
            out[name] = host
        else:
            out[name] = t.clone()
    if stream is not None:
        stream.synchronize()
    return {name: h.numpy() for name, h in out.items()}
