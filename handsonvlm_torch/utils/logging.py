"""File + stdout logging (reference: llava/utils.py build_logger).

A copy of `handsonvlm_tpu/utils/logging.py`, which imports no JAX.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_handlers = {}


def build_logger(name: str, log_file: Optional[str] = None, level=logging.INFO) -> logging.Logger:
    """Logger writing to stdout and (optionally) a file; idempotent."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s | %(levelname)s | %(name)s | %(message)s")
    if not any(isinstance(h, logging.StreamHandler) and h.stream is sys.stdout for h in logger.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_file:
        key = os.path.abspath(log_file)
        if key not in _handlers:
            os.makedirs(os.path.dirname(key) or ".", exist_ok=True)
            fh = logging.FileHandler(key, encoding="utf-8")
            fh.setFormatter(fmt)
            _handlers[key] = fh
        if _handlers[key] not in logger.handlers:
            logger.addHandler(_handlers[key])
    logger.propagate = False
    return logger
