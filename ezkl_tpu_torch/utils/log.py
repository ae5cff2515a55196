"""Level-filtered logging (port of `ezkl_tpu/utils/log.py`) — the analog of the reference's `env_logger`
setup (`ezkl/src/logger.rs`: colored level tags, env-controlled
filtering via RUST_LOG).

Env: `EZKL_TPU_LOG=debug|info|warn|error|off` (default `warn`, like the
reference's default env_logger level). `EZKL_TPU_TRACE=1` implies debug.
All output goes to stderr so stdout artifacts (proof JSON etc.) stay clean.
"""

from __future__ import annotations

import logging
import os
import sys
import time

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "off": logging.CRITICAL + 10,
}

_COLORS = {
    logging.DEBUG: "\x1b[90m",    # bright black
    logging.INFO: "\x1b[32m",     # green
    logging.WARNING: "\x1b[33m",  # yellow
    logging.ERROR: "\x1b[31m",    # red
}


class _Formatter(logging.Formatter):
    """`[ +12.3s LEVEL ezkl_tpu_torch.plonk] msg` with per-level color on TTYs."""

    t0 = time.time()

    def __init__(self, color: bool):
        super().__init__()
        self.color = color

    def format(self, record: logging.LogRecord) -> str:
        lvl = record.levelname
        if self.color:
            c = _COLORS.get(record.levelno, "")
            lvl = f"{c}{lvl}\x1b[0m"
        dt = record.created - self.t0
        return f"[ +{dt:7.1f}s {lvl} {record.name}] {record.getMessage()}"


def _level() -> int:
    env = os.environ.get("EZKL_TPU_LOG", "").lower()
    if not env and os.environ.get("EZKL_TPU_TRACE"):
        return logging.DEBUG
    return _LEVELS.get(env, logging.WARNING)


_root = logging.getLogger("ezkl_tpu_torch")
if not _root.handlers:
    _h = logging.StreamHandler(sys.stderr)
    try:
        _tty = sys.stderr.isatty()
    except Exception:
        _tty = False
    _h.setFormatter(_Formatter(color=_tty))
    _root.addHandler(_h)
    _root.setLevel(_level())
    _root.propagate = False


def get_logger(name: str = "") -> logging.Logger:
    """A level-filtered logger under the `ezkl_tpu_torch` root."""
    return logging.getLogger(f"ezkl_tpu_torch.{name}" if name else "ezkl_tpu_torch")


def set_level(name: str):
    _root.setLevel(_LEVELS.get(name.lower(), logging.WARNING))


debug = _root.debug
info = _root.info
warn = _root.warning
error = _root.error
