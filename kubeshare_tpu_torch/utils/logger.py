"""Single-line component loggers.

The port's own copy of kubeshare_tpu/utils/logger.py (the port imports
nothing of the JAX package).

The reference logs one line per event as ``<ts> <LEVEL>: <file>:<line> <msg>``
to ``/kubeshare/log/<component>.log`` (ref pkg/logger/logger.go:40-57) with a
level flag offset by 2.  Same format here, built on stdlib logging; file
output is opt-in (tests and library use stay on stderr) and falls back to
stderr when the log directory is not writable.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_FORMAT = "%(asctime)s %(levelname).4s: %(filename)s:%(lineno)d %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"

# reference level flag: 0..3 -> Error..Debug (offset by 2 into logrus levels)
_LEVELS = {0: logging.ERROR, 1: logging.WARNING, 2: logging.INFO, 3: logging.DEBUG}


def get_logger(
    name: str,
    level: int = 2,
    log_dir: Optional[str] = None,
    filename: Optional[str] = None,
) -> logging.Logger:
    """Build (or fetch) a component logger.

    ``level`` follows the reference CLI flag: 0=error 1=warn 2=info 3=debug;
    out-of-range values fall back to info (ref logger.go:42-45).
    """
    logger = logging.getLogger("kubeshare." + name)
    if logger.handlers:
        return logger
    logger.setLevel(_LEVELS.get(level, logging.INFO))
    logger.propagate = False

    handler: logging.Handler
    if log_dir is not None:
        try:
            os.makedirs(log_dir, exist_ok=True)
            handler = logging.FileHandler(
                os.path.join(log_dir, filename or (name + ".log"))
            )
        except OSError:
            handler = logging.StreamHandler(sys.stderr)
    else:
        handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
    logger.addHandler(handler)
    return logger


def configure_logger(
    name: str,
    level: int = 2,
    log_dir: Optional[str] = None,
    filename: Optional[str] = None,
) -> logging.Logger:
    """Explicitly (re)configure a component logger — daemon mains call this
    once at startup; library code uses get_logger, which never reconfigures."""
    logger = logging.getLogger("kubeshare." + name)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    return get_logger(name, level, log_dir, filename)
