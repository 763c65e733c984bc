"""Lightweight input pipeline feeding numpy batches to the train step
(copy of elasticdl_tpu/data/pipeline.py; pure numpy).

- Batches are numpy arrays (dicts of them), moved to the device once by
  the trainer.
- Shapes are static: partial batches are padded to ``batch_size`` and
  carry a float mask under the reserved key "_mask", so the loss and
  metrics weigh the padded rows out.
- Prefetching overlaps host-side parsing with device compute via a
  background thread.
- ``pad_batch`` and ``zero_batch_like`` feed the multi-process lockstep
  loop (worker/worker.py), where every process steps on batches of one
  shape.
"""

import queue
import random
import threading

import numpy as np

MASK_KEY = "_mask"


class _Flush:
    """Stream-control sentinel: "no more records are coming for now —
    emit what you are holding". The elastic training stream WAIT-loops
    on the master instead of ending (task_data_service
    .training_record_stream), so a tail of records smaller than one
    minibatch would otherwise sit in ``batch()``'s buffer forever
    while the master waits for their task to be reported — a mutual
    wait that hangs the job whenever dataset_size % minibatch != 0.
    The built-in
    combinators pass FLUSH through untouched (map/filter/take), drain
    their buffers on it (shuffle), or consume it by emitting the
    pending partial padded batch (batch)."""

    def __repr__(self):
        return "<FLUSH>"


FLUSH = _Flush()


class Dataset:
    """A re-iterable stream of examples with functional combinators."""

    def __init__(self, source_fn):
        # source_fn: () -> iterator of examples
        self._source_fn = source_fn

    def __iter__(self):
        return iter(self._source_fn())

    @staticmethod
    def from_iterable(iterable_fn):
        return Dataset(iterable_fn)

    @staticmethod
    def from_list(items):
        return Dataset(lambda: iter(items))

    def map(self, fn):
        def gen():
            for item in self._source_fn():
                yield item if item is FLUSH else fn(item)

        return Dataset(gen)

    def filter(self, predicate):
        def gen():
            for item in self._source_fn():
                if item is FLUSH or predicate(item):
                    yield item

        return Dataset(gen)

    def shuffle(self, buffer_size, seed=None):
        def gen():
            rng = random.Random(seed)
            buf = []
            for item in self._source_fn():
                if item is FLUSH:
                    rng.shuffle(buf)
                    yield from buf
                    buf = []
                    yield item
                    continue
                buf.append(item)
                if len(buf) >= buffer_size:
                    idx = rng.randrange(len(buf))
                    buf[idx], buf[-1] = buf[-1], buf[idx]
                    yield buf.pop()
            rng.shuffle(buf)
            yield from buf

        return Dataset(gen)

    def batch(self, batch_size, drop_remainder=False, pad_remainder=True):
        """Collate examples into stacked-numpy batches.

        The tail batch is padded (repeating the last example) with a
        ``_mask`` array marking real rows, unless dropped. A FLUSH
        sentinel forces the pending partial batch out the same way
        (and is consumed here — batches flow downstream, not
        sentinels).
        """

        def emit_partial(buf):
            real = len(buf)
            if pad_remainder:
                buf = buf + [buf[-1]] * (batch_size - real)
            return _collate(buf, len(buf), real=real)

        def gen():
            buf = []
            for item in self._source_fn():
                if item is FLUSH:
                    if buf and not drop_remainder:
                        yield emit_partial(buf)
                    # drop_remainder: the pending partial is CLEARED,
                    # not retained — these records would be dropped at
                    # end-of-stream anyway, and holding them past a
                    # FLUSH recreates the worker/master mutual-wait the
                    # sentinel exists to break (their task is never
                    # reported consumed while the master WAIT-loops)
                    buf = []
                    continue
                buf.append(item)
                if len(buf) == batch_size:
                    yield _collate(buf, batch_size, real=batch_size)
                    buf = []
            if buf and not drop_remainder:
                yield emit_partial(buf)

        return Dataset(gen)

    def prefetch(self, depth=2):
        def gen():
            q = queue.Queue(maxsize=depth)
            sentinel = object()
            error = []

            def producer():
                try:
                    for item in self._source_fn():
                        q.put(item)
                # propagated: the consumer loop re-raises error[0]
                except BaseException as e:  # edlint: disable=ft-swallowed-except
                    error.append(e)
                finally:
                    q.put(sentinel)

            t = threading.Thread(target=producer, daemon=True)
            t.start()
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item

        return Dataset(gen)

    def take(self, n):
        def gen():
            taken = 0
            for item in self._source_fn():
                if item is FLUSH:
                    yield item
                    continue
                if taken >= n:
                    return
                taken += 1
                yield item

        return Dataset(gen)


def _collate(examples, padded_size, real):
    """Stack a list of example pytrees into one batch pytree + mask."""
    mask = np.zeros((padded_size,), dtype=np.float32)
    mask[:real] = 1.0
    first = examples[0]
    if isinstance(first, dict):
        batch = {
            key: np.stack([np.asarray(e[key]) for e in examples])
            for key in first
        }
        batch[MASK_KEY] = mask
        return batch
    if isinstance(first, (tuple, list)):
        features = _stack_field([e[0] for e in examples])
        labels = _stack_field([e[1] for e in examples])
        return {"features": features, "labels": labels, MASK_KEY: mask}
    return {"features": np.stack([np.asarray(e) for e in examples]), MASK_KEY: mask}


def _stack_field(values):
    if isinstance(values[0], dict):
        return {
            key: np.stack([np.asarray(v[key]) for v in values])
            for key in values[0]
        }
    return np.stack([np.asarray(v) for v in values])


def batch_real_count(batch):
    mask = batch.get(MASK_KEY)
    if mask is None:
        raise KeyError("batch has no %r entry" % MASK_KEY)
    return int(mask.sum())


def normalize_outputs(outputs, real):
    """Slice model outputs to the real (unpadded) rows of a batch,
    wrapping a bare array as {"output": ...} for multi-output parity."""
    if isinstance(outputs, dict):
        return {k: np.asarray(v)[:real] for k, v in outputs.items()}
    return {"output": np.asarray(outputs)[:real]}


def _map_leaves(fn, tree):
    """``fn`` over every array leaf of a batch (dicts, tuples and named
    tuples such as ``PaddedSparse``; None stays None)."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def pad_batch(batch, size):
    """Zero-pad every leaf's leading dim to ``size``; padded rows carry
    mask 0 so the loss/metrics machinery weighs them out. Used by the
    multi-process lockstep loop, where every process must feed
    identically-shaped shards every step."""
    n = int(np.asarray(batch[MASK_KEY]).shape[0])
    if n == size:
        return batch
    if n > size:
        raise ValueError("batch of %d rows exceeds pad size %d" % (n, size))

    def pad(leaf):
        leaf = np.asarray(leaf)
        fill = np.zeros((size - n,) + leaf.shape[1:], leaf.dtype)
        return np.concatenate([leaf, fill], axis=0)

    return _map_leaves(pad, batch)


def zero_batch_like(batch):
    """An all-padding batch (mask 0 everywhere): a lockstep process
    whose task stream ran dry feeds these until the consensus says
    every process is done."""
    return _map_leaves(lambda leaf: np.zeros_like(np.asarray(leaf)), batch)
