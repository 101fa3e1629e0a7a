"""Structured logging (a copy of ``tensorlink_tpu/utils/logging.py``,
which uses no framework: the port keeps its own so that it never imports
the JAX package). Loggers live under ``tensorlink_tpu_torch``, and the
JSON formatter stamps trace ids from the port's ``runtime/tracing.py``.

Replaces the reference's root-logger file handler configured at import time
plus ANSI debug_print (src/p2p/smart_node.py:32-39,286-292) with namespaced
loggers configured on first use, JSON-formatted records optional.
"""

from __future__ import annotations

import json
import logging
import sys
import time

_CONFIGURED = False


# Attributes every LogRecord carries (plus the two the logging module
# adds after construction): anything else on the record arrived via
# ``extra={...}`` and belongs in the JSON payload.
_RECORD_DEFAULTS = frozenset(vars(logging.makeLogRecord({}))) | {
    "message",
    "asctime",
    "taskName",  # added by 3.12 asyncio logging
}


class JsonFormatter(logging.Formatter):
    """One JSON object per record. ``extra={...}`` fields are included
    (the stdlib stores them as record attributes; dropping them silently
    was the round-0 behavior), and when a tracing span is active the
    record is stamped with its trace_id/span_id so logs join traces —
    grep a trace id across node logs and the /spans timeline."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": time.time(),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        for k, v in record.__dict__.items():
            if k not in _RECORD_DEFAULTS and not k.startswith("_"):
                out.setdefault(k, v)
        # only consult the tracer if its module is ALREADY loaded: no
        # span can be active otherwise, and importing it here would drag
        # the runtime package (and torch) into torch-free logging consumers
        tracing = sys.modules.get("tensorlink_tpu_torch.runtime.tracing")
        if tracing is not None:
            span = tracing.current_span()
            if span is not None:
                out["trace_id"] = span.trace_id
                out["span_id"] = span.span_id
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        # default=str: extras are arbitrary objects; a log line must
        # never raise from serialization
        return json.dumps(out, default=str)


def get_logger(
    name: str, json_format: bool | None = None, level: int | None = None
):
    """Namespaced logger. ``json_format``/``level`` reconfigure the shared
    root handler whenever passed explicitly (not just on first call)."""
    global _CONFIGURED
    logger = logging.getLogger(f"tensorlink_tpu_torch.{name}")
    root = logging.getLogger("tensorlink_tpu_torch")
    if not _CONFIGURED:
        root.addHandler(logging.StreamHandler(sys.stderr))
        root.setLevel(logging.INFO)
        root.propagate = False
        _CONFIGURED = True
    if json_format is not None or not root.handlers[0].formatter:
        root.handlers[0].setFormatter(
            JsonFormatter()
            if json_format
            else logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
    if level is not None:
        root.setLevel(level)
    return logger
