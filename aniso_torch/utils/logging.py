"""Leveled colored logger (role of reference contrib/logging.m + cprintf.m).

Copy of aniso_tpu/utils/logging.py; the threshold comes from
ANISO_TORCH_LOGLEVEL.

Same level ladder as the reference (logging.m:2-8): DEBUG 0, INFO 1,
WARNING 2, ERROR 3, CRITICAL 4, NOTSET 5; default threshold WARNING
(logging.m:16).  Timestamped, ANSI-colored when the stream is a TTY.
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import TextIO

DEBUG, INFO, WARNING, ERROR, CRITICAL, NOTSET = 0, 1, 2, 3, 4, 5

_COLORS = {
    DEBUG: "\x1b[33m",     # yellow   (logging.m debug [1 1 0.2])
    INFO: "\x1b[32m",      # green    (logging.m info  [0 0.8 0])
    WARNING: "\x1b[38;5;208m",  # orange (logging.m warning [1 0.6 0.2])
    ERROR: "\x1b[31m",     # red      (logging.m error [1 0 0])
    CRITICAL: "\x1b[36m",  # cyan     (logging.m critical [0 1 1])
}
_RESET = "\x1b[0m"
_NAMES = {DEBUG: "DEBUG", INFO: "INFO", WARNING: "WARN", ERROR: "ERROR",
          CRITICAL: "CRIT"}


class Logger:
    def __init__(self, level: int = WARNING, stream: TextIO = None):
        self.level = level
        self.stream = stream if stream is not None else sys.stderr

    def setlevel(self, level: int) -> None:
        self.level = level

    def _emit(self, level: int, msg: str) -> None:
        if self.level > level:
            return
        ts = datetime.datetime.now().strftime("%d-%b-%Y %H:%M:%S")
        line = f"{ts} [{_NAMES[level]}] {msg}"
        use_color = (
            hasattr(self.stream, "isatty") and self.stream.isatty()
            and not os.environ.get("NO_COLOR")
        )
        if use_color:
            line = f"{_COLORS[level]}{line}{_RESET}"
        print(line, file=self.stream, flush=True)

    def debug(self, msg: str) -> None:
        self._emit(DEBUG, msg)

    def info(self, msg: str) -> None:
        self._emit(INFO, msg)

    def warning(self, msg: str) -> None:
        self._emit(WARNING, msg)

    def error(self, msg: str) -> None:
        self._emit(ERROR, msg)

    def critical(self, msg: str) -> None:
        self._emit(CRITICAL, msg)


# default INFO: cache-path selection and footprint reports must be visible
# by default (they explain order-of-magnitude setup/memory differences);
# quiet with ANISO_TORCH_LOGLEVEL=2 (WARNING)
log = Logger(level=int(os.environ.get("ANISO_TORCH_LOGLEVEL", INFO)))
