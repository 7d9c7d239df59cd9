"""Per-silo counters (the ``SiloMetrics`` counters of
``orleans_tpu/stats.py`` that the clustered vector data plane touches;
reference: MessagingStatisticsGroup.cs)."""

from __future__ import annotations

from typing import Dict


class SiloMetrics:

    def __init__(self) -> None:
        self.messages_sent = 0
        self.messages_received = 0
        self.messages_forwarded = 0
        self.dispatcher_received = 0
        self.rejections_sent = 0
        self.requests_timed_out = 0
        # one-ways and responses to a vanished peer (no bounce path)
        self.undeliverable_dropped = 0

    def snapshot(self) -> Dict[str, float]:
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float))}
