"""Streaming evaluation metrics (port of elasticdl_tpu/train/metrics.py:
``Metric``, ``Mean``, ``Accuracy`` and ``EvaluationMetrics``).

Small numpy accumulators with the ``update_state``/``result``/
``reset_states`` contract; model-zoo modules return them from
``eval_metrics_fn``. The JAX package's BinaryAccuracy, AUC and the
regression metrics wait for the models that use them.
"""

import numpy as np


class Metric:
    name = "metric"

    def update_state(self, labels, outputs):
        raise NotImplementedError

    def result(self):
        raise NotImplementedError

    def reset_states(self):
        raise NotImplementedError


class Mean(Metric):
    """Mean of a scalar stream (e.g. loss)."""

    def __init__(self, name="mean"):
        self.name = name
        self.reset_states()

    def reset_states(self):
        self._total = 0.0
        self._count = 0

    def update_state(self, labels, outputs):
        values = np.asarray(outputs, dtype=np.float64)
        self._total += float(values.sum())
        self._count += values.size

    def result(self):
        return self._total / max(self._count, 1)


class Accuracy(Metric):
    """Sparse categorical accuracy: argmax(outputs) == labels."""

    def __init__(self, name="accuracy"):
        self.name = name
        self.reset_states()

    def reset_states(self):
        self._correct = 0
        self._count = 0

    def update_state(self, labels, outputs):
        labels = np.asarray(labels).reshape(-1)
        outputs = np.asarray(outputs)
        if outputs.ndim > 1 and outputs.shape[-1] > 1:
            preds = np.argmax(outputs, axis=-1).reshape(-1)
        else:
            preds = np.round(outputs).astype(labels.dtype).reshape(-1)
        self._correct += int((preds == labels).sum())
        self._count += labels.size

    def result(self):
        return self._correct / max(self._count, 1)


class EvaluationMetrics:
    """Books metrics for single- or multi-output models.

    ``metrics_dict`` is either {metric_name: Metric} (single output) or
    {output_name: {metric_name: Metric}}.
    """

    def __init__(self, metrics_dict):
        self._nested = any(
            isinstance(v, dict) for v in metrics_dict.values()
        )
        self._metrics = metrics_dict

    def update_evaluation_metrics(self, model_outputs, labels):
        """model_outputs: {output_name: ndarray}; labels: ndarray."""
        if self._nested:
            for output_name, metrics in self._metrics.items():
                if output_name not in model_outputs:
                    continue
                outputs = model_outputs[output_name]
                for metric in metrics.values():
                    metric.update_state(labels, outputs)
        else:
            # single output: use the first (and only) reported tensor
            outputs = next(iter(model_outputs.values()))
            for metric in self._metrics.values():
                metric.update_state(labels, outputs)

    def get_evaluation_summary(self):
        if self._nested:
            return {
                output_name: {
                    name: metric.result() for name, metric in metrics.items()
                }
                for output_name, metrics in self._metrics.items()
            }
        return {name: metric.result() for name, metric in self._metrics.items()}

    def reset(self):
        stack = [self._metrics]
        while stack:
            current = stack.pop()
            for value in current.values():
                if isinstance(value, dict):
                    stack.append(value)
                else:
                    value.reset_states()
