"""Terminal progress reporting (port of `ezkl_tpu/utils/progress.py`) — the analog of the reference's `indicatif`
spinners/progress bars around long pipeline stages
(`ezkl/src/execute.rs:754-786`, calibration grid `:971`).

Enabled when stderr is a TTY; force on/off with EZKL_TPU_PROGRESS=1/0.
Single-line carriage-return updates; never interleaves with stdout
artifacts (JSON output etc. go to stdout, progress to stderr).
"""

from __future__ import annotations

import os
import sys
import time


def _enabled() -> bool:
    env = os.environ.get("EZKL_TPU_PROGRESS")
    if env is not None:
        return env not in ("0", "false", "")
    try:
        return sys.stderr.isatty()
    except Exception:
        return False


class Progress:
    """A labelled phase tracker: `step()` advances, `done()` closes the line.

    With `total` it renders `label [i/total] msg (elapsed)`, without it a
    spinner-style elapsed counter. No-op when disabled.
    """

    def __init__(self, label: str, total: int | None = None):
        self.label = label
        self.total = total
        self.i = 0
        self.t0 = time.time()
        self.on = _enabled()
        self._render("")

    def _render(self, msg: str):
        if not self.on:
            return
        dt = time.time() - self.t0
        frac = f"[{self.i}/{self.total}] " if self.total else ""
        sys.stderr.write(f"\r\x1b[2K{self.label} {frac}{msg} ({dt:.0f}s)")
        sys.stderr.flush()

    def step(self, msg: str = "", inc: int = 1):
        self.i += inc
        self._render(msg)

    def done(self, msg: str = "done"):
        self._render(msg)
        if self.on:
            sys.stderr.write("\n")
            sys.stderr.flush()


class _Null:
    def step(self, *a, **k):
        pass

    def done(self, *a, **k):
        pass


def progress(label: str, total: int | None = None):
    """Factory returning a Progress (or a no-op when disabled)."""
    return Progress(label, total) if _enabled() else _Null()
