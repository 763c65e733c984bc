"""Logging factory (copy of elasticdl_tpu/common/log_utils.py, trimmed
to the logger factory)."""

import logging

_DEFAULT_FMT = "%(asctime)s %(levelname)s %(name)s: %(message)s"

_initialized = False


def default_logger(name: str = "elasticdl_tpu_torch",
                   level: int = logging.INFO):
    global _initialized
    if not _initialized:
        logging.basicConfig(format=_DEFAULT_FMT)
        _initialized = True
    logger = logging.getLogger(name)
    logger.setLevel(level)
    return logger
