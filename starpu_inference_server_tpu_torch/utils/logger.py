"""Leveled, thread-safe logging.

Reference counterpart: src/utils/logger.hpp:20-120 — mutex-guarded
stdout/stderr logging with 5 verbosity levels (Silent/Info/Stats/Debug/
Trace), parsed from string or int.
"""

from __future__ import annotations

import enum
import sys
import threading
import time
from typing import Any, TextIO, Union


class Verbosity(enum.IntEnum):
    SILENT = 0
    INFO = 1
    STATS = 2
    DEBUG = 3
    TRACE = 4

    @classmethod
    def parse(cls, value: Union[str, int, "Verbosity"]) -> "Verbosity":
        if isinstance(value, Verbosity):
            return value
        if isinstance(value, bool):
            raise ValueError(f"invalid verbosity: {value!r}")
        if isinstance(value, int):
            if 0 <= value <= 4:
                return cls(value)
            raise ValueError(f"verbosity out of range [0,4]: {value}")
        name = str(value).strip().upper()
        if name.isdigit():
            return cls.parse(int(name))
        try:
            return cls[name]
        except KeyError:
            raise ValueError(f"invalid verbosity: {value!r}") from None


class Logger:
    """Minimal leveled logger writing to stdout (errors to stderr)."""

    def __init__(self, verbosity: Verbosity = Verbosity.INFO, name: str = "sis-tpu"):
        self.verbosity = Verbosity.parse(verbosity)
        self.name = name
        self._lock = threading.Lock()

    def _emit(self, stream: TextIO, tag: str, msg: str, *args: Any) -> None:
        if args:
            msg = msg % args
        stamp = time.strftime("%H:%M:%S", time.localtime())
        frac = f"{time.time() % 1:.3f}"[1:]
        with self._lock:
            stream.write(f"[{stamp}{frac}] [{self.name}] [{tag}] {msg}\n")
            stream.flush()

    def set_verbosity(self, value: Union[str, int, Verbosity]) -> None:
        self.verbosity = Verbosity.parse(value)

    def error(self, msg: str, *args: Any) -> None:
        self._emit(sys.stderr, "ERROR", msg, *args)

    def warn(self, msg: str, *args: Any) -> None:
        if self.verbosity >= Verbosity.INFO:
            self._emit(sys.stderr, "WARN", msg, *args)

    def info(self, msg: str, *args: Any) -> None:
        if self.verbosity >= Verbosity.INFO:
            self._emit(sys.stdout, "INFO", msg, *args)

    def stats(self, msg: str, *args: Any) -> None:
        if self.verbosity >= Verbosity.STATS:
            self._emit(sys.stdout, "STATS", msg, *args)

    def debug(self, msg: str, *args: Any) -> None:
        if self.verbosity >= Verbosity.DEBUG:
            self._emit(sys.stdout, "DEBUG", msg, *args)

    def trace(self, msg: str, *args: Any) -> None:
        if self.verbosity >= Verbosity.TRACE:
            self._emit(sys.stdout, "TRACE", msg, *args)


_global_logger = Logger()


def get_logger() -> Logger:
    return _global_logger


def set_global_verbosity(value: Union[str, int, Verbosity]) -> None:
    _global_logger.set_verbosity(value)
