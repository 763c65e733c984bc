"""Logging factory and the --log_level / --log_file_path flags (copy of
elasticdl_tpu/common/log_utils.py)."""

import logging

_DEFAULT_FMT = "%(asctime)s %(levelname)s %(name)s: %(message)s"

_initialized = False
# set by configure(); wins over the per-call default so loggers created
# after --log_level is applied still honor it
_configured_level = None
# the FileHandler installed by configure(); a second configure replaces
# it instead of stacking another
_file_handler = None


def default_logger(name: str = "elasticdl_tpu_torch",
                   level: int = logging.INFO):
    global _initialized
    if not _initialized:
        logging.basicConfig(format=_DEFAULT_FMT)
        _initialized = True
    logger = logging.getLogger(name)
    logger.setLevel(
        _configured_level if _configured_level is not None else level
    )
    return logger


def configure(log_level: str = "", log_file_path: str = ""):
    """Apply --log_level / --log_file_path to every elasticdl_tpu_torch
    logger: the package's level, and an optional file handler on the
    root logger."""
    global _configured_level, _file_handler
    if log_level:
        level = getattr(logging, log_level.upper(), None)
        if not isinstance(level, int):
            raise ValueError("unknown --log_level %r" % (log_level,))
        _configured_level = level
        # default_logger gave the existing loggers explicit levels
        for name, logger in logging.root.manager.loggerDict.items():
            if name.startswith("elasticdl_tpu_torch") and isinstance(
                logger, logging.Logger
            ):
                logger.setLevel(level)
        logging.getLogger("elasticdl_tpu_torch").setLevel(level)
    if log_file_path:
        root = logging.getLogger()
        if _file_handler is not None:
            root.removeHandler(_file_handler)
            _file_handler.close()
        _file_handler = logging.FileHandler(log_file_path)
        _file_handler.setFormatter(logging.Formatter(_DEFAULT_FMT))
        root.addHandler(_file_handler)
