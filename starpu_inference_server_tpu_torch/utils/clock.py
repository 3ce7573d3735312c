"""Monotonic clock helpers (reference: src/utils/monotonic_clock,
time_utils)."""

from __future__ import annotations

import time


def now_s() -> float:
    """Monotonic seconds (the framework's canonical timestamp)."""
    return time.monotonic()


def now_ns() -> int:
    return time.monotonic_ns()


def wall_ms() -> float:
    """Wall-clock milliseconds since epoch (for client_send_ms-style
    protocol fields; reference: grpc_service.proto:709-714)."""
    return time.time() * 1000.0


def to_ms(seconds: float) -> float:
    return seconds * 1000.0


class StopWatch:
    """RAII-ish elapsed-time helper."""

    def __init__(self) -> None:
        self.start = now_s()

    def elapsed_s(self) -> float:
        return now_s() - self.start

    def elapsed_ms(self) -> float:
        return self.elapsed_s() * 1000.0
