"""File + console logging (reference: `src/utils.py:9-28,45-49`)."""

from __future__ import annotations

import datetime
import logging
from pathlib import Path


def get_local_time() -> str:
    return datetime.datetime.now().strftime("%b-%d-%Y_%H-%M-%S")


def set_logger(log_path: str | Path, log_name: str = "seqrec", mode: str = "a") -> logging.Logger:
    logger = logging.getLogger(log_name)
    logger.setLevel(logging.INFO)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()

    Path(log_path).parent.mkdir(parents=True, exist_ok=True)
    formatter = logging.Formatter("%(asctime)s - %(message)s")
    fh = logging.FileHandler(log_path, mode=mode)
    fh.setFormatter(formatter)
    ch = logging.StreamHandler()
    ch.setFormatter(formatter)
    logger.addHandler(fh)
    logger.addHandler(ch)
    logger.propagate = False
    return logger
