"""Dual console and file logging (counterpart of
`icepy4d_tpu/utils/logger.py`), on the port's logger name."""

from __future__ import annotations

import functools
import logging
import warnings
from datetime import datetime
from pathlib import Path

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}

LOGGER_NAME = "icepy4d_tpu_torch"


def setup_logger(
    log_folder: str | Path | None = None,
    base_filename: str = "icepy4d_tpu_torch",
    console_log_level: str = "info",
    logfile_level: str = "info",
) -> logging.Logger:
    """(Re)configure the port's logger: a console handler at
    `console_log_level` and, with `log_folder`, a time-stamped log file
    there at `logfile_level`."""
    if console_log_level not in _LEVELS or logfile_level not in _LEVELS:
        raise ValueError(
            f"Invalid log level; choose from {sorted(_LEVELS)}"
        )
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()

    fmt = logging.Formatter(
        "%(asctime)s | %(levelname)-8s | %(message)s", "%H:%M:%S"
    )
    ch = logging.StreamHandler()
    ch.setLevel(_LEVELS[console_log_level])
    ch.setFormatter(fmt)
    logger.addHandler(ch)

    if log_folder is not None:
        folder = Path(log_folder)
        folder.mkdir(parents=True, exist_ok=True)
        stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        fh = logging.FileHandler(folder / f"{base_filename}_{stamp}.log")
        fh.setLevel(_LEVELS[logfile_level])
        fh.setFormatter(
            logging.Formatter(
                "%(asctime)s | %(levelname)-8s | %(module)s:%(lineno)d | %(message)s"
            )
        )
        logger.addHandler(fh)
    return logger


def get_logger(name: str = LOGGER_NAME) -> logging.Logger:
    """The named logger, set up with a console handler on first use."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        setup_logger()
    return logger


def deprecated(reason: str = ""):
    """Decorator: calling the function warns with DeprecationWarning."""
    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            warnings.warn(
                f"{func.__name__} is deprecated. {reason}",
                DeprecationWarning,
                stacklevel=2,
            )
            return func(*args, **kwargs)

        return wrapper

    return decorator
