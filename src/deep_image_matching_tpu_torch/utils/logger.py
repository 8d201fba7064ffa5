"""Colorized console + optional file logging.

Parity: reference ``utils/logger.py:31-96`` (single "dim" logger, console
handler with per-level colors, optional timestamped file handler,
``change_logger_level``).
"""

from __future__ import annotations

import logging
import sys
from datetime import datetime
from pathlib import Path
from typing import Optional

LOGGER_NAME = "dim_tpu_torch"

_COLORS = {
    logging.DEBUG: "\x1b[36m",     # cyan
    logging.INFO: "\x1b[32m",      # green
    logging.WARNING: "\x1b[33m",   # yellow
    logging.ERROR: "\x1b[31m",     # red
    logging.CRITICAL: "\x1b[41m",  # red background
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    def __init__(self, use_color: bool = True):
        super().__init__()
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        base = f"%(asctime)s | [%(levelname)-8s] %(message)s"
        if self.use_color and record.levelno in _COLORS:
            base = _COLORS[record.levelno] + base + _RESET
        return logging.Formatter(base, datefmt="%Y-%m-%d %H:%M:%S").format(record)


def setup_logger(
    name: str = LOGGER_NAME,
    log_level: str = "info",
    log_folder: Optional[str] = None,
    logfile_basename: str = "log",
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if not any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
        console = logging.StreamHandler(sys.stdout)
        console.setLevel(getattr(logging, log_level.upper()))
        console.setFormatter(_ColorFormatter(use_color=sys.stdout.isatty()))
        logger.addHandler(console)
    if log_folder is not None:
        folder = Path(log_folder)
        folder.mkdir(parents=True, exist_ok=True)
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        fh = logging.FileHandler(folder / f"{logfile_basename}_{stamp}.log")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(
            logging.Formatter(
                "%(asctime)s | [%(levelname)-8s] %(message)s",
                datefmt="%Y-%m-%d %H:%M:%S",
            )
        )
        logger.addHandler(fh)
    return logger


def change_logger_level(name: str, level: str) -> None:
    logger = logging.getLogger(name)
    for handler in logger.handlers:
        if isinstance(handler, logging.StreamHandler):
            handler.setLevel(getattr(logging, level.upper()))


logger = setup_logger()
