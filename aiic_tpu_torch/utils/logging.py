"""Structured logging — a copy of ``aiic_tpu.utils.logging`` (no JAX in it).

Human-readable lines by default, JSON lines when ``AIIC_LOG_JSON=1`` (for
log aggregation in deployment).
"""

from __future__ import annotations

import json
import logging
import os
import sys


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        extra = getattr(record, "fields", None)
        if extra:
            out.update(extra)
        return json.dumps(out, ensure_ascii=False)


def get_logger(name: str = "aiic") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        if os.environ.get("AIIC_LOG_JSON") == "1":
            handler.setFormatter(_JsonFormatter())
        else:
            handler.setFormatter(
                logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
            )
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("AIIC_LOG_LEVEL", "INFO"))
        logger.propagate = False
    return logger


def log_event(logger: logging.Logger, msg: str, **fields) -> None:
    logger.info(msg, extra={"fields": fields})
