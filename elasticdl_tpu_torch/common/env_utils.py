"""Env-knob parsing (copy of elasticdl_tpu/common/env_utils.py, trimmed
to the knobs the serving and training paths read)."""

import os

from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)

logger = _logger_factory("elasticdl_tpu_torch.common.env_utils")


def env_int(name, default):
    """int(os.environ[name]) with ``default`` for unset/empty; a
    non-numeric value logs a warning and falls back."""
    raw = os.environ.get(name, "")
    if not raw:
        return int(default)
    try:
        return int(raw)
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r", name, raw)
        return int(default)


def env_float(name, default):
    raw = os.environ.get(name, "")
    if not raw:
        return float(default)
    try:
        return float(raw)
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r", name, raw)
        return float(default)


def env_str(name, default=""):
    return os.environ.get(name, default)


_TRUTHY = frozenset({"1", "true", "yes", "on"})
_FALSY = frozenset({"0", "false", "no", "off", ""})


def env_bool(name, default=False):
    """Boolean knob: 1/true/yes/on and 0/false/no/off (case-blind).
    Unset returns ``default``; an unrecognized value logs a warning and
    falls back."""
    raw = os.environ.get(name)
    if raw is None:
        return bool(default)
    low = raw.strip().lower()
    if low in _TRUTHY:
        return True
    if low in _FALSY:
        return False
    logger.warning("ignoring non-boolean %s=%r", name, raw)
    return bool(default)
