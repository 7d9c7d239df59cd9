"""Structured logging with error codes and bulk throttling (a copy of
``orleans_tpu/tracing.py``).

Parity: reference TraceLogger (reference: src/Orleans/Logging/
TraceLogger.cs:44 — bulk-message throttling :90-102, per-code ErrorCode).
Each silo gets a named stdlib logger; repeated (level, code) pairs inside
a time window collapse, as the reference's BulkMessageLimit does.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Tuple

BULK_LIMIT = 5           # (reference: BulkMessageLimit default)
BULK_WINDOW = 60.0       # seconds (reference: BulkMessageInterval)


class TraceLogger:

    def __init__(self, name: str, level: int = logging.INFO) -> None:
        self._log = logging.getLogger(f"orleans_tpu_torch.{name}")
        self._log.setLevel(level)
        self._bulk: Dict[Tuple[int, int], Tuple[float, int]] = {}
        self.bulk_limit = BULK_LIMIT
        self.bulk_window = BULK_WINDOW

    def child(self, suffix: str) -> "TraceLogger":
        return TraceLogger(
            f"{self._log.name.removeprefix('orleans_tpu_torch.')}.{suffix}")

    def _throttled(self, level: int, code: int) -> bool:
        """(reference: TraceLogger bulk throttling :90-102)"""
        if code == 0:
            return False
        now = time.monotonic()
        start, count = self._bulk.get((level, code), (now, 0))
        if now - start > self.bulk_window:
            if count > self.bulk_limit:
                self._log.log(level, "[code %d] suppressed %d messages in "
                              "the last %ds bulk window", code,
                              count - self.bulk_limit, int(self.bulk_window))
            start, count = now, 0
        count += 1
        self._bulk[(level, code)] = (start, count)
        if count == self.bulk_limit + 1:
            self._log.log(level, "[code %d] further messages suppressed for "
                          "%ds (bulk limit)", code, int(self.bulk_window))
        return count > self.bulk_limit

    def _emit(self, level: int, msg: str, code: int, exc_info=None) -> None:
        if self._throttled(level, code):
            return
        if code:
            msg = f"[code {code}] {msg}"
        self._log.log(level, msg, exc_info=exc_info)

    def debug(self, msg: str, code: int = 0) -> None:
        self._emit(logging.DEBUG, msg, code)

    def info(self, msg: str, code: int = 0) -> None:
        self._emit(logging.INFO, msg, code)

    def warn(self, msg: str, code: int = 0, exc_info=None) -> None:
        self._emit(logging.WARNING, msg, code, exc_info)

    def error(self, msg: str, code: int = 0, exc_info=None) -> None:
        self._emit(logging.ERROR, msg, code, exc_info)
