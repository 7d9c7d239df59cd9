"""Device resolution and the card report.

The port runs on the card unless the caller asks for the CPU: ``None``
means ``"cuda"``, and a CUDA request on a machine without a usable card
raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

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
