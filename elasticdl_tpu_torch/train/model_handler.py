"""Promotion of big embeddings to the host PS, and the export of their
tables beside the dense state (port of
elasticdl_tpu/train/model_handler.py).

Under the PS strategy the reference's model handler swaps an embedding
whose table is over 2 MiB for a PS-backed one, and undoes it at export
time. A model built from feature columns (preprocessing/
feature_column.py) passes its column list through
``promote_large_embeddings``: an ``EmbeddingColumn`` whose fp32 table is
over the threshold becomes a ``PSEmbeddingColumn``, whose table lives
on the host PS and whose rows ``SparseTrainer`` pulls before the step
(through the device tier when it is on: K1-K3). Smaller tables stay
device parameters of ``DenseFeatures``. The plan's ``materialize_ids``
resolves each promoted column's ids and mask on the host, in the
dataset_fn or before ``SparseBatchPreparer.prepare``.

The export is the inverse: the PS rows of each promoted table are
pulled back as one dense array and bundled with the dense export
(``sparse_tables.npz`` beside ``model.npz``, the same file in both
packages), so a server needs no PS to serve.
"""

import os

import numpy as np

from elasticdl_tpu_torch.preprocessing.feature_column import (
    DenseFeatures,
    EmbeddingColumn,
    _consumes_strings,
    _feature_keys,
    combine_gathered,
)
from elasticdl_tpu_torch.preprocessing.sparse import _host
from elasticdl_tpu_torch.train.export import export_train_state
from elasticdl_tpu_torch.train.sparse import (
    INDICES_SUFFIX,
    ROWS_SUFFIX,
    SparseEmbeddingSpec,
)

SPARSE_TABLES_FILE = "sparse_tables.npz"

# the reference promotes an embedding whose table is over 2 MiB
EMBEDDING_PROMOTION_THRESHOLD_BYTES = 2 * 1024 * 1024

MASK_SUFFIX = "__psmask"
WEIGHTS_SUFFIX = "__psweights"
IDS_PREFIX = "__psids__"


def table_size_bytes(column: EmbeddingColumn, dtype_bytes=4):
    rows, dim = column.table_shape
    return int(rows) * int(dim) * dtype_bytes


class PSEmbeddingColumn:
    """Embedding column whose table lives on the host PS.

    Reads the (rows, indices) pair SparseBatchPreparer plants and the
    mask (and weights) the plan's ``materialize_ids`` plants, and
    combines on the device. DenseFeatures treats it as a plain callable
    column: it owns no parameter.
    """

    def __init__(self, source: EmbeddingColumn):
        self.source = source
        self.categorical = None  # opt out of DenseFeatures.preprocess
        self.dimension = source.dimension
        self.combiner = source.combiner
        self.output_dim = source.dimension
        self.table_name = source.name
        self.num_buckets = source.categorical.num_buckets

    @property
    def name(self):
        return self.source.name

    def __call__(self, features):
        rows = features[self.table_name + ROWS_SUFFIX]
        indices = features[self.table_name + INDICES_SUFFIX]
        mask = features[self.table_name + MASK_SUFFIX]
        gathered = rows[indices.long()]  # [B, F, dim]
        w = mask.to(gathered.dtype)
        weights_key = self.table_name + WEIGHTS_SUFFIX
        if weights_key in features:
            w = w * features[weights_key].to(gathered.dtype)
        return combine_gathered(gathered, w, self.combiner)


class PromotionPlan:
    """What promote_large_embeddings decided: the rewritten column list,
    the host-PS table specs, and the host-side id materializer that runs
    before ``SparseBatchPreparer.prepare``."""

    def __init__(self, columns, promoted, kept):
        self.columns = list(columns)
        self.promoted = list(promoted)  # [PSEmbeddingColumn]
        self.kept = list(kept)
        self.sparse_specs = [
            SparseEmbeddingSpec(
                name=col.table_name,
                dim=col.dimension,
                feature_key=IDS_PREFIX + col.table_name,
                combiner=None,  # PSEmbeddingColumn combines with the mask
                # padded slots must not pull or update PS rows
                mask_feature_key=col.table_name + MASK_SUFFIX,
            )
            for col in self.promoted
        ]
        # string keys consumed ONLY by promoted columns are dropped
        # after id materialization, so the step never sees them
        kept_string_keys = set()
        for col in self.kept:
            cat = getattr(col, "categorical", None)
            if cat is not None and _consumes_strings(cat):
                kept_string_keys.update(_feature_keys(cat))
        self._droppable = set()
        for col in self.promoted:
            cat = col.source.categorical
            if _consumes_strings(cat):
                self._droppable.update(
                    _feature_keys(cat) - kept_string_keys
                )

    @property
    def table_shapes(self):
        return {
            col.table_name: (col.num_buckets, col.dimension)
            for col in self.promoted
        }

    def materialize_ids(self, features):
        """Host-side stage: each promoted column's categorical resolved
        to padded int64 ids (0 on padded slots) and a bool mask (and
        float32 weights) as numpy features. Returns a new features dict
        without the raw string keys only the promoted columns read. Runs
        on the CPU: numpy features make CPU tensors, so the input
        pipeline never waits on the card."""
        out = dict(features)
        for col in self.promoted:
            sp = col.source.categorical.ids(features)
            values = _host(sp.values)
            mask = _host(sp.mask).astype(bool)
            out[IDS_PREFIX + col.table_name] = np.where(
                mask, values, 0
            ).astype(np.int64)
            out[col.table_name + MASK_SUFFIX] = mask
            if sp.weights is not None:
                out[col.table_name + WEIGHTS_SUFFIX] = _host(
                    sp.weights).astype(np.float32)
        for key in self._droppable:
            out.pop(key, None)
        return out


def promote_large_embeddings(
    columns, threshold_bytes=EMBEDDING_PROMOTION_THRESHOLD_BYTES
):
    """Split a column list into device-resident and host-PS embeddings:
    an EmbeddingColumn whose float32 table is over ``threshold_bytes``
    becomes a PSEmbeddingColumn; everything else passes through."""
    new_columns, promoted, kept = [], [], []
    for col in columns:
        if (
            isinstance(col, EmbeddingColumn)
            and table_size_bytes(col) > threshold_bytes
        ):
            ps_col = PSEmbeddingColumn(col)
            new_columns.append(ps_col)
            promoted.append(ps_col)
        else:
            new_columns.append(col)
            kept.append(col)
    return PromotionPlan(new_columns, promoted, kept)


def dense_features(plan: PromotionPlan):
    return DenseFeatures(columns=tuple(plan.columns))


def pull_full_table(ps_client, name, num_rows, dim, chunk_size=4096):
    """A host-PS table as one dense [num_rows, dim] float32 array, ids
    0..num_rows-1 pulled in chunks of ``chunk_size``."""
    table = np.zeros((num_rows, dim), dtype=np.float32)
    for start in range(0, num_rows, chunk_size):
        ids = np.arange(start, min(start + chunk_size, num_rows),
                        dtype=np.int64)
        table[start:start + len(ids)] = ps_client.pull_embedding_vectors(
            name, ids)
    return table


def export_promoted_train_state(state, plan, ps_client, path):
    """Export the dense state and the plan's host-PS tables (anything
    with a ``table_shapes`` mapping ``{table: (num_rows, dim)}``, as a
    ``PromotionPlan``) as one serving bundle."""
    export_train_state(state, path)
    tables = {
        name: pull_full_table(ps_client, name, rows, dim)
        for name, (rows, dim) in plan.table_shapes.items()
    }
    if tables:
        np.savez(os.path.join(path, SPARSE_TABLES_FILE), **tables)
    return path


def load_exported_tables(path):
    """{table: [num_rows, dim] array} of a promoted export; {} when the
    bundle has none."""
    fname = os.path.join(path, SPARSE_TABLES_FILE)
    if not os.path.exists(fname):
        return {}
    with np.load(fname, allow_pickle=False) as data:
        return {name: data[name] for name in data.files}
