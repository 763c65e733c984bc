"""Export of host-PS embedding tables beside the dense state (port of
elasticdl_tpu/train/model_handler.py, its export half).

The reference's promoted export is the inverse rewrite of its model
handler: the PS rows of each promoted table are pulled back as one
dense array and bundled with the dense export, so a server needs no PS
to serve (``sparse_tables.npz`` beside ``model.npz``, the same file in
both packages).

Not ported (ROADMAP): the promotion plan itself
(``promote_large_embeddings``, ``PSEmbeddingColumn``,
``PromotionPlan``), which needs ``preprocessing/feature_column.py``.
Here ``plan`` is anything with a ``table_shapes`` mapping
``{table: (num_rows, dim)}``, as the reference's ``PromotionPlan``
has.
"""

import os

import numpy as np

from elasticdl_tpu_torch.train.export import export_train_state

SPARSE_TABLES_FILE = "sparse_tables.npz"


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
    """Export the dense state and the plan's host-PS tables as one
    serving bundle."""
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
