"""Logging (reference include/LightGBM/utils/log.h:26-98).

Four levels with a process-wide threshold mapped from the ``verbose``
config (config.cpp verbosity mapping): verbose<=0 -> Warning+,
verbose==1 -> Info+, verbose>=2 -> Debug+.  ``Log.fatal`` raises
:class:`LightGBMError` like the reference's throwing Log::Fatal
(log.h:65-78, caught in main.cpp:9-22).
"""

from __future__ import annotations

import sys

DEBUG, INFO, WARNING, FATAL = 0, 1, 2, 3


class Log:
    _level = INFO

    @classmethod
    def reset_log_level(cls, verbose: int) -> None:
        cls._level = WARNING if verbose <= 0 else (INFO if verbose == 1 else DEBUG)

    @classmethod
    def debug(cls, msg: str) -> None:
        if cls._level <= DEBUG:
            print(f"[LightGBM] [Debug] {msg}", flush=True)

    @classmethod
    def info(cls, msg: str) -> None:
        if cls._level <= INFO:
            print(f"[LightGBM] [Info] {msg}", flush=True)

    @classmethod
    def warning(cls, msg: str) -> None:
        print(f"[LightGBM] [Warning] {msg}", file=sys.stderr, flush=True)

    @classmethod
    def fatal(cls, msg: str) -> None:
        from .basic import LightGBMError

        print(f"[LightGBM] [Fatal] {msg}", file=sys.stderr, flush=True)
        raise LightGBMError(msg)
