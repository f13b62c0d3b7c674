"""Structured JSON-lines stage logging — the native analog of the
reference's `log`/`env_logger` backend (reference: zkit/src/main.rs:266
`env_logger::try_init`, per-stage `log::info!` calls throughout
starky/recursion/zkvm).

One env flag yields a machine-readable trace of a full chain run:

    EIGEN_ZKVM_LOG=1             -> JSON lines on stderr
    EIGEN_ZKVM_LOG=/path/x.jsonl -> JSON lines appended to a file

Each record is one JSON object:

    {"ts": <unix seconds>, "elapsed": <s since process log start>,
     "event": "<component.stage>", ...free-form fields...}

Emitters use `span("stark_gen.stage1", nbits=20, engine="tpu")` as a
context manager (adds "wall" seconds on exit, "error" on exception) or
`log_event("zkvm.chunk", idx=3, rows=65536)` for point events.
Zero overhead when disabled: one module-bool check, no timestamps taken.

Copy of eigen_zkvm_tpu/utils/structlog.py.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time

_dest = os.environ.get("EIGEN_ZKVM_LOG", "")
_t0 = time.time()


def enabled() -> bool:
    return bool(_dest)


def _emit(rec: dict):
    line = json.dumps(rec, separators=(",", ":"), default=str)
    if _dest in ("1", "true", "stderr"):
        print(line, file=sys.stderr, flush=True)
    else:
        with open(_dest, "a") as f:
            f.write(line + "\n")


def log_event(event: str, **fields):
    """Point event; no-op unless EIGEN_ZKVM_LOG is set."""
    if not _dest:
        return
    now = time.time()
    rec = {"ts": round(now, 3), "elapsed": round(now - _t0, 3),
           "event": event}
    rec.update(fields)
    _emit(rec)


@contextlib.contextmanager
def span(event: str, **fields):
    """Timed stage: emits one record on exit with `wall` seconds (and
    `error` if the body raised).  No-op unless EIGEN_ZKVM_LOG is set."""
    if not _dest:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    except BaseException as e:
        log_event(event, wall=round(time.perf_counter() - t0, 4),
                  error=f"{type(e).__name__}: {e}", **fields)
        raise
    log_event(event, wall=round(time.perf_counter() - t0, 4), **fields)
