"""Structured JSON logging, flattened fields — the shape of the
reference's tracing-subscriber setup (reference src/main.rs:42-62):
one JSON object per line, `suppress_logging` raises the level to
WARNING, otherwise INFO."""

from __future__ import annotations

import datetime
import json
import logging
import sys


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        obj = {
            "timestamp": datetime.datetime.now(datetime.timezone.utc).isoformat(),
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        extra = getattr(record, "fields", None)
        if isinstance(extra, dict):
            obj.update(extra)  # flattened, like .flatten_event(true)
        if record.exc_info and record.exc_info[0] is not None:
            obj["exception"] = self.formatException(record.exc_info)
        return json.dumps(obj, ensure_ascii=False)


def setup(suppress_logging: bool = False) -> None:
    level = logging.WARNING if suppress_logging else logging.INFO
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(JsonFormatter())
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(level)
