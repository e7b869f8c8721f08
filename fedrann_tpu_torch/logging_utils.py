"""Logging: colored console + plain-text file handler (the same surface as
`fedrann_tpu/logging_utils.py`, under the logger name `fedrann_tpu_torch`)."""

from __future__ import annotations

import logging
import sys

_COLORS = {
    logging.DEBUG: "\x1b[36m",     # cyan
    logging.INFO: "\x1b[32m",      # green
    logging.WARNING: "\x1b[33m",   # yellow
    logging.ERROR: "\x1b[31m",     # red
    logging.CRITICAL: "\x1b[35m",  # magenta
}
_RESET = "\x1b[0m"

_FMT = "%(asctime)s [%(levelname)s] %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"


class ColoredFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        text = super().format(record)
        color = _COLORS.get(record.levelno, "")
        return f"{color}{text}{_RESET}" if color and sys.stderr.isatty() else text


logger = logging.getLogger("fedrann_tpu_torch")
if not logger.handlers:
    _console = logging.StreamHandler(sys.stderr)
    _console.setFormatter(ColoredFormatter(_FMT, _DATEFMT))
    logger.addHandler(_console)
    logger.setLevel(logging.INFO)
    logger.propagate = False


def set_logging_level(level: str | int) -> None:
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    logger.setLevel(level)


def add_log_file(path: str) -> logging.Handler:
    """Attach a color-free file handler; pass the result to remove_log_file
    when the run ends."""
    handler = logging.FileHandler(path, mode="w")
    handler.setFormatter(logging.Formatter(_FMT, _DATEFMT))
    logger.addHandler(handler)
    return handler


def remove_log_file(handler: logging.Handler) -> None:
    logger.removeHandler(handler)
    handler.close()
