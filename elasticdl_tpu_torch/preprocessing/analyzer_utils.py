"""Feature-statistics lookup from the environment (copy of
elasticdl_tpu/preprocessing/analyzer_utils.py).

A SQLFlow analysis job plants per-feature min/max/mean/stddev/vocab
statistics into environment variables; model code reads them with a
default fallback so it also runs without the analysis step.
"""

import os

_MIN_ENV = "_edl_analysis_min_{}"
_MAX_ENV = "_edl_analysis_max_{}"
_MEAN_ENV = "_edl_analysis_mean_{}"
_STDDEV_ENV = "_edl_analysis_stddev_{}"
_COUNT_ENV = "_edl_analysis_distinct_count_{}"
_VOCAB_ENV = "_edl_analysis_vocab_{}"


def _get_float(template, feature_name, default_value):
    value = os.getenv(template.format(feature_name))
    return default_value if value is None else float(value)


def get_min(feature_name, default_value):
    return _get_float(_MIN_ENV, feature_name, default_value)


def get_max(feature_name, default_value):
    return _get_float(_MAX_ENV, feature_name, default_value)


def get_mean(feature_name, default_value):
    return _get_float(_MEAN_ENV, feature_name, default_value)


def get_stddev(feature_name, default_value):
    return _get_float(_STDDEV_ENV, feature_name, default_value)


def get_distinct_count(feature_name, default_value):
    value = os.getenv(_COUNT_ENV.format(feature_name))
    return default_value if value is None else int(value)


def get_vocabulary(feature_name, default_value=None):
    """Comma-separated vocabulary planted by the analysis job."""
    value = os.getenv(_VOCAB_ENV.format(feature_name))
    if value is None:
        return default_value
    return [term for term in value.split(",") if term]
