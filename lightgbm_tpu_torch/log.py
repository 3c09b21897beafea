"""Leveled logger + CHECK asserts.

Reference: include/LightGBM/utils/log.h — `Log::{Debug,Info,Warning,
Fatal}` gated by a process-wide verbosity, and `CHECK()`/`CHECK_NOTNULL()`
fatal asserts that raise instead of aborting (log.h:17-38).

Verbosity mapping follows the reference config semantics
(`verbosity`/`verbose`): <0 fatal-only, 0 warnings, 1 info (default),
>=2 debug.  `configure(verbose)` is called by the CLI and the Python
entry points whenever a Config is parsed.
"""
from __future__ import annotations

import sys
from typing import Any, Optional

FATAL = -1
WARNING = 0
INFO = 1
DEBUG = 2

_level = INFO


class LightGBMError(Exception):
    """The package-wide error type (mirrors the reference's thrown
    std::runtime_error from Log::Fatal)."""


def configure(verbose: int) -> None:
    global _level
    _level = int(verbose)


def level() -> int:
    return _level


def debug(msg: str) -> None:
    if _level >= DEBUG:
        print(f"[LightGBM-TPU] [Debug] {msg}", flush=True)


def info(msg: str) -> None:
    if _level >= INFO:
        print(f"[LightGBM-TPU] [Info] {msg}", flush=True)


def warning(msg: str) -> None:
    if _level >= WARNING:
        print(f"[LightGBM-TPU] [Warning] {msg}", file=sys.stderr,
              flush=True)


def fatal(msg: str) -> None:
    """Log and raise (log.h:27-33: Fatal always prints, then throws)."""
    print(f"[LightGBM-TPU] [Fatal] {msg}", file=sys.stderr, flush=True)
    raise LightGBMError(msg)


def check(cond: bool, msg: str = "") -> None:
    """CHECK(condition) (log.h:17-19)."""
    if not cond:
        fatal(f"Check failed: {msg}" if msg else "Check failed")


def check_notnull(value: Optional[Any], name: str = "value") -> Any:
    """CHECK_NOTNULL (log.h:21-23)."""
    if value is None:
        fatal(f"{name} must not be None")
    return value
