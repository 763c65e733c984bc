"""Streaming evaluation metrics (port of elasticdl_tpu/train/metrics.py:
``Metric``, ``Mean``, ``Accuracy``, ``BinaryAccuracy``, ``AUC`` and
``EvaluationMetrics``).

Small numpy accumulators with the ``update_state``/``result``/
``reset_states`` contract; model-zoo modules return them from
``eval_metrics_fn``. The JAX package's regression metrics wait for the
models that use them.
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


class BinaryAccuracy(Metric):
    def __init__(self, threshold=0.5, from_logits=False,
                 name="binary_accuracy"):
        self.name = name
        self._threshold = threshold
        self._from_logits = from_logits
        self.reset_states()

    def reset_states(self):
        self._correct = 0
        self._count = 0

    def update_state(self, labels, outputs):
        labels = np.asarray(labels).reshape(-1)
        outputs = np.asarray(outputs, dtype=np.float64).reshape(-1)
        if self._from_logits:
            outputs = 1.0 / (1.0 + np.exp(-outputs))
        preds = (outputs >= self._threshold).astype(labels.dtype)
        self._correct += int((preds == labels).sum())
        self._count += labels.size

    def result(self):
        return self._correct / max(self._count, 1)


class AUC(Metric):
    """Exact ROC AUC via the rank statistic over buffered scores (the
    Mann-Whitney U form, ties at their average rank)."""

    def __init__(self, from_logits=False, name="auc"):
        self.name = name
        self._from_logits = from_logits
        self.reset_states()

    def reset_states(self):
        self._scores = []
        self._labels = []

    def update_state(self, labels, outputs):
        outputs = np.asarray(outputs, dtype=np.float64).reshape(-1)
        if self._from_logits:
            outputs = 1.0 / (1.0 + np.exp(-outputs))
        self._scores.append(outputs)
        self._labels.append(np.asarray(labels).reshape(-1).astype(np.int64))

    def result(self):
        if not self._scores:
            return 0.0
        scores = np.concatenate(self._scores)
        labels = np.concatenate(self._labels)
        pos = int(labels.sum())
        neg = labels.size - pos
        if pos == 0 or neg == 0:
            return 0.0
        order = np.argsort(scores, kind="mergesort")
        sorted_scores = scores[order]
        # average ranks over ties: each run of equal scores shares the
        # mean of its 1-based ranks
        starts = np.concatenate(
            ([0], np.nonzero(np.diff(sorted_scores))[0] + 1))
        ends = np.append(starts[1:], scores.size)
        run_ranks = 0.5 * (starts + 1 + ends)
        ranks = np.empty(scores.size, dtype=np.float64)
        ranks[order] = np.repeat(run_ranks, ends - starts)
        rank_sum_pos = float(ranks[labels == 1].sum())
        u = rank_sum_pos - pos * (pos + 1) / 2.0
        return u / (pos * neg)


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
