"""In-process PS client: an embedding store behind the PSClient surface
(port of elasticdl_tpu/ps/local_client.py).

Lets ``LocalExecutor`` and ``SparseTrainer`` run sparse models with no
gRPC and no PS process.

``EDL_WIRE_DTYPE`` is honoured as precision emulation: pulled rows and
pushed gradients round-trip through the configured wire dtype (down
and back up, no serialization), so a local run trains with exactly the
rounding a worker<->PS deployment under the knob would see.

The pull and apply spans carry ``role="ps"``: the process plays both
roles, and a local trace attributes them as a worker<->PS topology does.
"""

import numpy as np

from elasticdl_tpu_torch.common.tensor_utils import (
    deduplicate_indexed_slices,
    normalize_id_tables,
    wire_round_trip,
)
from elasticdl_tpu_torch.observability import trace
from elasticdl_tpu_torch.ps.embedding_store import (
    create_store,
    parse_initializer,
)
from elasticdl_tpu_torch.worker.ps_client import PushResult


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
        with trace.span("ps_pull", role="ps", table=name):
            rows = self.store.lookup(name, np.asarray(ids, dtype=np.int64))
            return wire_round_trip(rows)

    def pull_embedding_batch(self, ids_by_table):
        """{table: ids} -> {table: rows}; the in-process analogue of
        the fused multi-table pull RPC."""
        return {
            name: self.pull_embedding_vectors(name, ids)
            for name, ids in normalize_id_tables(ids_by_table).items()
        }

    def push_embedding_rows(self, rows_by_table, sightings=None):
        """Device-tier writeback: raw row values overwrite the store
        (no optimizer math, no version bump and no wire round trip:
        writebacks are authoritative fp32 master copies even under
        EDL_WIRE_DTYPE). ``sightings`` feed a PS's embedding lifecycle;
        this client has none, so they are dropped."""
        for name, (ids, values) in rows_by_table.items():
            ids = np.asarray(ids, dtype=np.int64)
            if not ids.size:
                continue
            self.store.import_table(
                name, ids, np.asarray(values, dtype=np.float32)
            )

    @property
    def ps_num(self):
        return 1

    def push_gradients(self, grads_by_table, model_version=0, lr_scale=0.0,
                       only_shards=None, force_empty=False,
                       round_scoped=False):
        """Apply at once: one in-process store, so every push is
        accepted. ``lr_scale`` multiplies the store optimizer's learning
        rate (0 = no scaling, as on the wire); ``model_version`` and the
        sync-pairing arguments (``only_shards``, ``force_empty``,
        ``round_scoped``) are taken for the PSClient surface and have
        nothing to pair here."""
        del only_shards, force_empty, round_scoped
        lr_scale = lr_scale if lr_scale > 0 else 1.0
        with trace.span("ps_apply_push", role="ps", version=model_version):
            for name, (values, ids) in grads_by_table.items():
                values, ids = deduplicate_indexed_slices(
                    np.asarray(values), np.asarray(ids, dtype=np.int64)
                )
                values = wire_round_trip(
                    np.asarray(values, dtype=np.float32))
                self.store.push_gradients(name, ids, values,
                                          lr_scale=lr_scale)
            self.store.bump_version()
        return PushResult(True, self.store.version)
