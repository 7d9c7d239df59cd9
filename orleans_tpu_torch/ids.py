"""Identity helpers (the part of ``orleans_tpu/ids.py`` the port needs)."""

from __future__ import annotations

from orleans_tpu_torch.hashing import jenkins_hash


def type_code_of(type_name: str) -> int:
    """Stable 31-bit type code for a grain interface/class name.

    Reference analog: GrainInterfaceData.GetGrainInterfaceId — codegen'd
    integer ids; here derived by stable hash of the name (no codegen step).
    """
    return jenkins_hash(type_name.encode("utf-8")) & 0x7FFFFFFF
