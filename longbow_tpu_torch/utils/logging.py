"""Structured JSON logging.

Counterpart of longbow_tpu/utils/logging.py (reference: zerolog JSON
logs, logging/logger.go:34-100; the level from the environment).
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time


class JSONFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(time.time(), 6),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        fields = getattr(record, "fields", None)
        if fields:
            out.update(fields)
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def setup_logging(name: str = "longbow") -> logging.Logger:
    """The logger `name`, writing to stderr as JSON (LONGBOW_LOG_FORMAT
    "json", the default) or as text, at LONGBOW_LOG_LEVEL (default info)."""
    level = os.environ.get("LONGBOW_LOG_LEVEL", "info").upper()
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        fmt = os.environ.get("LONGBOW_LOG_FORMAT", "json")
        if fmt == "json":
            h.setFormatter(JSONFormatter())
        else:
            h.setFormatter(
                logging.Formatter("%(asctime)s %(levelname)s %(message)s")
            )
        logger.addHandler(h)
    logger.setLevel(getattr(logging, level, logging.INFO))
    return logger
