"""ANSI-coloured logging (counterpart of `evoworld_tpu/utils/logging.py`;
upstream `dataset/colorsetting.py`).

`ColoredFormatter` wraps each line in its level's colour, byte for byte as
the JAX package's does. The port's handler writes to whatever `sys.stderr`
is when a record is emitted (a handler bound to the stream of its creation
keeps writing to one that a caller, such as a test runner's capture, has
since replaced and closed), and colours the lines only where that stream is
a terminal, so that a log file or a pipe holds no escape codes.
"""

from __future__ import annotations

import logging
import sys

_COLORS = {
    logging.DEBUG: "\033[36m",     # cyan
    logging.INFO: "\033[32m",      # green
    logging.WARNING: "\033[33m",   # yellow
    logging.ERROR: "\033[31m",     # red
    logging.CRITICAL: "\033[35m",  # magenta
}
_RESET = "\033[0m"
FORMAT = "%(asctime)s - %(levelname)s - %(message)s"


class ColoredFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        color = _COLORS.get(record.levelno, "")
        message = super().format(record)
        return f"{color}{message}{_RESET}" if color else message


class StderrHandler(logging.StreamHandler):
    """A stream handler on the current `sys.stderr`, coloured on a terminal."""

    def __init__(self):
        super().__init__()
        self._colored = ColoredFormatter(FORMAT)
        self._plain = logging.Formatter(FORMAT)

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, value):
        pass

    def format(self, record: logging.LogRecord) -> str:
        isatty = getattr(sys.stderr, "isatty", None)
        return (self._colored if isatty is not None and isatty() else self._plain).format(record)


def get_logger(name: str = "evoworld_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    """The named logger with one `StderrHandler` at `level` (added once per process)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.addHandler(StderrHandler())
        logger.setLevel(level)
        logger.propagate = False
    return logger
