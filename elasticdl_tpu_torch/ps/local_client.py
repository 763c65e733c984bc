"""In-process PS client: an embedding store behind the PSClient surface
(port of elasticdl_tpu/ps/local_client.py, without its trace spans).

Lets ``LocalExecutor`` and ``SparseTrainer`` run sparse models with no
gRPC and no PS process.

``EDL_WIRE_DTYPE`` is honoured as precision emulation: pulled rows and
pushed gradients round-trip through the configured wire dtype (down
and back up, no serialization), so a local run trains with exactly the
rounding a worker<->PS deployment under the knob would see.
"""

import numpy as np

from elasticdl_tpu_torch.common.tensor_utils import (
    deduplicate_indexed_slices,
    normalize_id_tables,
    wire_round_trip,
)
from elasticdl_tpu_torch.ps.embedding_store import (
    create_store,
    parse_initializer,
)


class LocalPSClient:
    def __init__(self, store=None, seed=0, opt_type="adam", **opt_args):
        self.store = store or create_store(seed=seed)
        if store is None:
            self.store.set_optimizer(opt_type, **opt_args)

    def push_embedding_table_infos(self, infos):
        for name, dim, init_spec in infos:
            kind, param = parse_initializer(init_spec)
            self.store.create_table(
                name, dim, init_scale=param, initializer=kind
            )

    def pull_embedding_vectors(self, name, ids):
        rows = self.store.lookup(name, np.asarray(ids, dtype=np.int64))
        return wire_round_trip(rows)

    def pull_embedding_batch(self, ids_by_table):
        """{table: ids} -> {table: rows}; the in-process analogue of
        the fused multi-table pull RPC."""
        return {
            name: self.pull_embedding_vectors(name, ids)
            for name, ids in normalize_id_tables(ids_by_table).items()
        }

    def push_embedding_rows(self, rows_by_table):
        """Device-tier writeback: raw row values overwrite the store
        (no optimizer math, no version bump and no wire round trip:
        writebacks are authoritative fp32 master copies even under
        EDL_WIRE_DTYPE)."""
        for name, (ids, values) in rows_by_table.items():
            ids = np.asarray(ids, dtype=np.int64)
            if not ids.size:
                continue
            self.store.import_table(
                name, ids, np.asarray(values, dtype=np.float32)
            )

    def push_gradients(self, grads_by_table, model_version=0):
        """Apply at once (one in-process store, so every push is
        accepted); ``model_version`` is the worker's and is not checked."""
        del model_version
        for name, (values, ids) in grads_by_table.items():
            values, ids = deduplicate_indexed_slices(
                np.asarray(values), np.asarray(ids, dtype=np.int64)
            )
            values = wire_round_trip(np.asarray(values, dtype=np.float32))
            self.store.push_gradients(name, ids, values)
        self.store.bump_version()
        return True, self.store.version
