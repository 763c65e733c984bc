"""The port imports nothing of JAX or of the JAX package, and never
falls back to the CPU on its own.

Every module of ``elasticdl_tpu_torch`` is imported in a subprocess
whose meta-path finder refuses jax, flax, optax, orbax, ml_dtypes and
elasticdl_tpu (and evicts any of them imported before it was
installed).
"""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import elasticdl_tpu_torch
from elasticdl_tpu_torch.common.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps these small-shape tests from oversubscribing
# the host's cores under other files' timing-sensitive tests
torch.set_num_threads(1)

_BLOCK = r'''
import importlib, importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes",
           "elasticdl_tpu")
def _blocked(name):
    return name.split(".")[0] in BLOCKED
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if _blocked(name):
            raise ImportError("blocked import of %s" % name)
        return None
for name in [m for m in sys.modules if _blocked(m)]:
    del sys.modules[name]
sys.meta_path.insert(0, _Block())
'''
_BLOCKER = _BLOCK + r'''
for name in sys.argv[1:]:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if _blocked(m))
assert not leaked, leaked
print("imported", len(sys.argv) - 1)
'''


def _port_modules():
    names = [elasticdl_tpu_torch.__name__]
    for info in pkgutil.walk_packages(
        elasticdl_tpu_torch.__path__, prefix="elasticdl_tpu_torch."
    ):
        names.append(info.name)
    return sorted(names)


def test_every_port_module_imports_with_jax_blocked():
    modules = _port_modules()
    assert "elasticdl_tpu_torch.ops.flash_attention" in modules
    assert "elasticdl_tpu_torch.serve.main" in modules
    for name in ("stream.source", "stream.feeder", "stream.lifecycle",
                 "testing.faults", "master.tensorboard_service",
                 "ops.moe", "models.moe_transformer", "data.table_reader",
                 "data.table_writer"):
        assert "elasticdl_tpu_torch." + name in modules
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKER, *modules],
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"), cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "imported %d" % len(modules)


def test_port_sources_name_no_jax_import():
    """Belt and braces over the runtime check: no source line of the
    port or of chip_smoke.py imports JAX or the JAX package, even in a
    branch the import above never runs."""
    import re

    pattern = re.compile(
        r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|orbax|ml_dtypes|"
        r"elasticdl_tpu)(\.|\s|$)"
    )
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "elasticdl_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                if pattern.match(line):
                    offenders.append("%s:%d: %s" % (path, lineno, line.strip()))
    assert not offenders, offenders


def test_cuda_without_a_card_raises_not_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device(None)  # the default is the card
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("tpu")


def test_serve_role_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    from elasticdl_tpu_torch.serve.main import ServeRole, parse_serve_args

    args = parse_serve_args([
        "--model_zoo", "elasticdl_tpu_torch.models.transformer",
        "--export_dir", str(tmp_path),
    ])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        ServeRole(args)


def test_training_entry_points_default_to_cuda_and_raise_without_a_card(
        tmp_path):
    """The training slice's modules are among those imported with JAX
    blocked above, and its entry points (LocalExecutor, TorchTrainer)
    default to the card and refuse to run without one."""
    modules = _port_modules()
    for name in ("train.local_executor", "worker.trainer", "train.step_fns",
                 "train.optimizers", "train.health", "data.readers",
                 "data.example", "train.metrics"):
        assert "elasticdl_tpu_torch." + name in modules, name
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    import inspect

    from elasticdl_tpu_torch.models import transformer
    from elasticdl_tpu_torch.train.local_executor import LocalExecutor
    from elasticdl_tpu_torch.worker.trainer import TorchTrainer

    for entry in (LocalExecutor, TorchTrainer):
        default = inspect.signature(entry).parameters["device"].default
        assert default == "cuda", entry
    with pytest.raises(RuntimeError, match="cuda"):
        LocalExecutor("elasticdl_tpu_torch.models.transformer",
                      training_data=str(tmp_path))
    model = transformer.TransformerLM(vocab_size=8, num_layers=1,
                                      num_heads=1, embed_dim=64)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchTrainer(model, transformer.loss, transformer.optimizer())


def test_sparse_slice_modules_isolated_and_entry_points_default_to_cuda(
        tmp_path):
    """The sparse slice's modules are among those imported with JAX
    blocked above, and its entry points (LocalExecutor on DeepFM,
    SparseTrainer) default to the card and refuse to run without one."""
    modules = _port_modules()
    for name in ("ps", "ps.embedding_store", "ps.local_client",
                 "embedding", "embedding.client", "ops.embedding_tier",
                 "train.device_tier", "train.sparse", "models.deepfm"):
        assert "elasticdl_tpu_torch." + name in modules, name
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    import inspect

    from elasticdl_tpu_torch.models import deepfm
    from elasticdl_tpu_torch.ps.local_client import LocalPSClient
    from elasticdl_tpu_torch.train.local_executor import LocalExecutor
    from elasticdl_tpu_torch.train.sparse import SparseTrainer

    from elasticdl_tpu_torch.train.device_tier import (
        DeviceEmbeddingTier,
        DeviceTierConfig,
    )

    for entry in (SparseTrainer, DeviceEmbeddingTier):
        assert inspect.signature(entry).parameters["device"].default == (
            "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceEmbeddingTier(deepfm.sparse_embedding_specs(), LocalPSClient(),
                            DeviceTierConfig(capacity=4))
    with pytest.raises(RuntimeError, match="cuda"):
        LocalExecutor("elasticdl_tpu_torch.models.deepfm",
                      training_data=str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        SparseTrainer(deepfm.custom_model(), deepfm.loss, deepfm.optimizer(),
                      deepfm.sparse_embedding_specs(), LocalPSClient())


def test_native_store_builds_and_trains_with_jax_blocked():
    """The native store module and its build (make, g++) need nothing of
    JAX or the JAX package: with them blocked, create_store gives the
    native store, built from the port's own source (never the JAX
    package's native/ directory), and a push moves a looked-up row."""
    code = _BLOCK + r'''
import numpy as np
from elasticdl_tpu_torch.ps import embedding_store as s
store = s.create_store(seed=0)
assert isinstance(store, s.NativeEmbeddingStore), type(store)
assert store.library_path.startswith(s.STORE_BUILD_DIR)
assert s.NATIVE_DIR.endswith("elasticdl_tpu_torch/native")
store.set_optimizer("sgd", lr=0.5)
store.create_table("t", 2, initializer="zeros")
store.push_gradients("t", [3], np.ones((1, 2), np.float32))
assert store.lookup("t", [3]).tolist() == [[-0.5, -0.5]]
leaked = sorted(m for m in sys.modules if _blocked(m))
assert not leaked, leaked
print("native ok")
'''
    out = subprocess.run(
        [sys.executable, "-c", code],
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"), cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "native ok"


def test_stream_slice_modules_isolated_and_ps_server_runs_with_jax_blocked():
    """The stream slice's modules (the gRPC PS, its client, the
    overload discipline, the cache, Timing) are among those imported
    with JAX blocked above; ``python -m elasticdl_tpu_torch.ps.server``
    serves a pull and drains on SIGTERM (exit 0) with JAX blocked; and
    SparseTrainer, now with the stream, still defaults to the card."""
    import inspect
    import signal
    import time

    import numpy as np

    from elasticdl_tpu_torch.common.grpc_utils import find_free_port
    from elasticdl_tpu_torch.train.sparse import SparseTrainer
    from elasticdl_tpu_torch.worker.ps_client import PSClient

    modules = _port_modules()
    for name in ("common.args", "common.overload", "common.grpc_utils",
                 "common.timing_utils", "common.tensor_utils",
                 "proto.services", "ps.servicer", "ps.server",
                 "worker.ps_client", "embedding.client"):
        assert "elasticdl_tpu_torch." + name in modules, name
    assert inspect.signature(SparseTrainer).parameters["device"].default == (
        "cuda")
    port = find_free_port()
    code = _BLOCK + r'''
import runpy
sys.argv = ["ps", "--port", "%d", "--num_ps_pods", "2", "--opt_type", "adam",
            "--opt_args", "lr=0.001"]
try:
    runpy.run_module("elasticdl_tpu_torch.ps.server", run_name="__main__")
    status = None
except SystemExit as stop:
    status = stop.code
leaked = sorted(m for m in sys.modules if _blocked(m))
assert not leaked, leaked
print("exit", status)
''' % port
    proc = subprocess.Popen(
        [sys.executable, "-c", code],
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:  # a fresh client per probe
                client = PSClient(["localhost:%d" % port])
                client.push_embedding_table_infos([("t", 2, "zeros")])
                break
            except Exception:
                assert proc.poll() is None, proc.communicate()
                assert time.monotonic() < deadline
                time.sleep(0.2)
        rows = client.pull_embedding_batch({"t": np.arange(3)})["t"]
        assert rows.shape == (3, 2) and not rows.any()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert out.strip() == "exit 0", (out, err)
    if torch.cuda.is_available():
        return
    from elasticdl_tpu_torch.models import deepfm

    with pytest.raises(RuntimeError, match="cuda"):
        SparseTrainer(deepfm.custom_model(), deepfm.loss, deepfm.optimizer(),
                      deepfm.sparse_embedding_specs(),
                      PSClient(["localhost:%d" % port]), cache_staleness=8)


def test_job_slice_modules_isolated_and_the_worker_defaults_to_cuda():
    """The job slice's modules (the master, the worker, the worker's
    master client, the PS's master poll) are among those imported with
    JAX blocked above; the worker's entry point and ``Worker`` default
    to the card, while the master and the PS take no device."""
    import inspect

    from elasticdl_tpu_torch.common.args import parse_worker_args
    from elasticdl_tpu_torch.worker.worker import Worker

    modules = _port_modules()
    for name in ("master.task_dispatcher", "master.evaluation_service",
                 "master.rendezvous", "master.servicer",
                 "master.task_monitor", "master.master", "master.main",
                 "worker.master_client", "worker.task_data_service",
                 "worker.worker", "worker.main", "ps.server"):
        assert "elasticdl_tpu_torch." + name in modules, name
    assert inspect.signature(Worker).parameters["device"].default == "cuda"
    args = parse_worker_args(["--model_zoo", "m", "--master_addr", "a:1",
                              "--worker_id", "0"])
    assert args.device == "cuda"


def test_checkpoint_module_isolated_and_a_chain_round_trips_with_jax_blocked(
        tmp_path):
    """``ps.checkpoint`` is among the modules imported with JAX blocked
    above, and with JAX and the JAX package blocked it saves a chain (a
    full base and a delta with a tombstone) from the native store and
    restores it into the numpy store bit for bit."""
    assert "elasticdl_tpu_torch.ps.checkpoint" in _port_modules()
    code = _BLOCK + r'''
import numpy as np
from elasticdl_tpu_torch.ps.checkpoint import SparseCheckpointSaver
from elasticdl_tpu_torch.ps.embedding_store import (
    NativeEmbeddingStore, NumpyEmbeddingStore)
stores = []
for cls in (NativeEmbeddingStore, NumpyEmbeddingStore):
    store = cls(seed=0)
    store.set_optimizer("adam", lr=0.1)
    store.create_table("t", 3, initializer="zeros")
    stores.append(store)
live, restored = stores
saver = SparseCheckpointSaver(sys.argv[1], compact_every=4)
live.push_gradients("t", np.arange(6), np.ones((6, 3), np.float32))
assert saver.save(1, live).kind == "full"
live.drop_rows("t", np.array([2]))
live.push_gradients("t", np.arange(3, 6), np.ones((3, 3), np.float32))
assert saver.save(2, live).tombstones == 1
assert SparseCheckpointSaver(sys.argv[1]).restore(restored) == 2
want, got = live.export_table_full("t"), restored.export_table_full("t")
order_w, order_g = np.argsort(want[0]), np.argsort(got[0])
for w, g in zip(want, got):
    assert np.array_equal(w[order_w], g[order_g])
assert 2 not in got[0]
leaked = sorted(m for m in sys.modules if _blocked(m))
assert not leaked, leaked
print("checkpoint ok")
'''
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "ckpt")],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "checkpoint ok"


def test_artifact_slice_modules_isolated_and_entry_points_default_to_cuda(
        tmp_path):
    """The artifact slice's modules (callbacks, dense checkpoints, the
    promoted export, the prediction sink) are among those imported with
    JAX blocked above, and its entry points (the worker that saves and
    restores dense checkpoints, the serving engine over the PS) default
    to the card and refuse to run without one."""
    modules = _port_modules()
    for name in ("train.callbacks", "train.checkpoint",
                 "train.model_handler", "models.deepfm_predictions",
                 "worker.worker", "serve.engine", "serve.model"):
        assert "elasticdl_tpu_torch." + name in modules, name
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    import inspect

    from elasticdl_tpu_torch.ps.local_client import LocalPSClient
    from elasticdl_tpu_torch.serve.engine import ServingEngine
    from elasticdl_tpu_torch.worker.worker import Worker

    for entry in (Worker, ServingEngine):
        default = inspect.signature(entry).parameters["device"].default
        assert default == "cuda", entry
    with pytest.raises(RuntimeError, match="cuda"):
        Worker(None, "elasticdl_tpu_torch.models.deepfm", None,
               checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_steps=4,
               checkpoint_dir_for_init=str(tmp_path / "init"))
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine("elasticdl_tpu_torch.models.deepfm",
                      str(tmp_path / "export"), ps_client=LocalPSClient())


def test_control_slice_modules_isolated_and_a_journal_replays_with_jax_blocked(
        tmp_path):
    """The control slice's modules (the state journal, the drain
    manager, the worker's SIGTERM hook) are among those imported with
    JAX blocked above, and with JAX and the JAX package blocked a
    dispatcher journals a task and a relaunched one replays it: the
    task in flight goes back to the queue and the boot counter moves."""
    modules = _port_modules()
    for name in ("master.state_store", "master.autoscaler", "worker.drain"):
        assert "elasticdl_tpu_torch." + name in modules, name
    code = _BLOCK + r'''
from elasticdl_tpu_torch.master.state_store import MasterStateJournal
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
journal = MasterStateJournal(sys.argv[1])
assert journal.load() is None
first = TaskDispatcher({"f": (0, 8)}, records_per_task=4, seed=0,
                       state_journal=journal)
held = first.get(0)
journal.close()
journal = MasterStateJournal(sys.argv[1])
second = TaskDispatcher({"f": (0, 8)}, records_per_task=4, seed=0,
                        state_journal=journal, recovered=journal.load())
assert journal.master_epoch == 2
assert second.stats()["queue_depth"]["training"] == 2
assert held.task_id in [second.get(1).task_id, second.get(1).task_id]
leaked = sorted(m for m in sys.modules if _blocked(m))
assert not leaked, leaked
print("journal ok")
'''
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "state")],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "journal ok"


TELEMETRY_MODULES = (
    "observability.metrics", "observability.events", "observability.trace",
    "observability.trace_propagation", "observability.grpc_metrics",
    "observability.http_server", "master.fleet", "observability.device",
    "observability.profiler",
)


def test_telemetry_slice_modules_isolated_and_observed_with_jax_blocked(
        tmp_path):
    """The telemetry slice's nine modules import with JAX and the JAX
    package blocked (in a fresh process, each alone), and with them
    blocked a master's fleet monitor folds a blob, raises an alert
    behind /alerts, journals it, and the device telemetry answers on
    the CPU."""
    modules = _port_modules()
    for name in TELEMETRY_MODULES:
        assert "elasticdl_tpu_torch." + name in modules, name
    for name in TELEMETRY_MODULES:
        out = subprocess.run(
            [sys.executable, "-c", _BLOCKER, "elasticdl_tpu_torch." + name],
            env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, (name, out.stderr)
    code = _BLOCK + r'''
import json, os, urllib.request
os.environ["EDL_EVENTS_DIR"] = sys.argv[1]
os.environ["EDL_HBM_LIMIT_BYTES"] = "100"
from elasticdl_tpu_torch.master.fleet import FleetMonitor
from elasticdl_tpu_torch.observability import device, events, http_server
from elasticdl_tpu_torch.observability.metrics import Registry
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
journal = events.configure("master")
fleet = FleetMonitor(version_lag_max=10)
fleet.observe(-1, pb.TelemetryBlob(role="ps-0", version_lag=50))
server = http_server.ObservabilityServer(
    "master", 0, registry=Registry(enabled=True)).start()
server.add_json_handler("/alerts", fleet.alerts)
fleet.evaluate()
body = urllib.request.urlopen(
    "http://localhost:%d/alerts" % server.port, timeout=5).read()
server.stop()
assert [a["alert"] for a in json.loads(body)] == ["version_lag"]
with open(journal.path) as f:
    assert "alert_raised" in f.read()
assert device.telemetry()["hbm_limit_bytes"] == 100
leaked = sorted(m for m in sys.modules if _blocked(m))
assert not leaked, leaked
print("observed ok")
'''
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "events")],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "observed ok"


def test_ctr_zoo_trains_with_jax_blocked():
    """The CTR zoo's modules are among those imported with JAX blocked
    above, and with JAX blocked a DCN at a small vocab sizes its lazy
    layers, draws flax's initializers and takes one training step on
    the CPU."""
    modules = _port_modules()
    for name in ("models.ctr", "models.wide_deep", "models.dcn",
                 "models.xdeepfm"):
        assert "elasticdl_tpu_torch." + name in modules, name
    code = _BLOCK + r'''
import numpy as np
from elasticdl_tpu_torch.models import ctr
from elasticdl_tpu_torch.worker.trainer import TorchTrainer
ids = np.random.RandomState(0).randint(0, 50, size=(8, 5))
batch = {"features": {"ids": ids}, "labels": np.ones(8, np.float32),
         "_mask": np.ones(8, np.float32)}
trainer = TorchTrainer(ctr.custom_model("dcn", vocab=50, embed_dim=4),
                       ctr.loss, ctr.optimizer(), health=False, device="cpu")
state, loss = trainer.train_step(None, batch)
assert state.step == 1 and np.isfinite(float(loss))
leaked = sorted(m for m in sys.modules if _blocked(m))
assert not leaked, leaked
print("trained")
'''
    out = subprocess.run(
        [sys.executable, "-c", code],
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"), cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "trained"


def test_feature_column_slice_modules_isolated_and_train_with_jax_blocked():
    """The feature-column slice's modules are among those imported with
    JAX blocked above; with JAX blocked a promoted model (a
    variable-length column on the PS under the mean combiner) and
    census_dnn each take a step on the CPU, and iris reads its CSV."""
    modules = _port_modules()
    for name in ("preprocessing", "preprocessing.sparse",
                 "preprocessing.layers", "preprocessing.analyzer_utils",
                 "preprocessing.feature_column", "data.census_schema",
                 "data.gen", "data.gen.converters", "models.feature_net",
                 "models.census_dnn", "models.census_wide_deep",
                 "models.census_sqlflow_wide_deep", "models.heart",
                 "models.iris_dnn", "train.model_handler"):
        assert "elasticdl_tpu_torch." + name in modules, name
    code = _BLOCK + r'''
import os, sys, tempfile
import numpy as np
from elasticdl_tpu_torch.data.gen import gen_census_recordio
from elasticdl_tpu_torch.models.layers import Dense, FlaxNamed
from elasticdl_tpu_torch.preprocessing import feature_column as fc
from elasticdl_tpu_torch.preprocessing.sparse import from_row_lists
from elasticdl_tpu_torch.ps.local_client import LocalPSClient
from elasticdl_tpu_torch.train import model_handler as mh
from elasticdl_tpu_torch.train.local_executor import LocalExecutor
from elasticdl_tpu_torch.train.losses import sigmoid_binary_cross_entropy
from elasticdl_tpu_torch.train.optimizers import create_optimizer
from elasticdl_tpu_torch.train.sparse import SparseTrainer
import torch
col = fc.embedding_column(fc.categorical_column_with_identity("tags", 10**6),
                          dimension=8, combiner="mean")
plan = mh.promote_large_embeddings([col, fc.numeric_column("x")])
assert plan.table_shapes == {"tags_embedding": (10**6, 8)}
class M(FlaxNamed):
    def __init__(self):
        super().__init__()
        self.f = mh.dense_features(plan)
        self.d = Dense(self.f.output_dim, 1)
    def forward(self, features):
        return self.d(self.f(features))[:, 0]
trainer = SparseTrainer(M(), sigmoid_binary_cross_entropy,
                        create_optimizer("Adam", learning_rate=0.01),
                        plan.sparse_specs, LocalPSClient(), device="cpu",
                        health=False)
rows = [[1, 2], [3], [4, 5, 6], [7]]
batch = {"features": plan.materialize_ids({"tags": from_row_lists(rows),
                                           "x": np.ones(4, np.float32)}),
         "labels": np.ones(4, np.float32), "_mask": np.ones(4, np.float32)}
state, loss = trainer.train_step(trainer.ensure_state(None, batch), batch)
assert state.step == 1 and np.isfinite(float(loss))
d = tempfile.mkdtemp()
gen_census_recordio(d, num_records=64)
ex = LocalExecutor("elasticdl_tpu_torch.models.census_dnn", training_data=d,
                   minibatch_size=32, device="cpu")
assert len(ex.train()) == 2
with open(os.path.join(d, "iris.csv"), "w") as f:
    f.write("a,b,c,d,label\n" + "1,2,3,4,1\n" * 8)
ex = LocalExecutor("elasticdl_tpu_torch.models.iris_dnn",
                   training_data=os.path.join(d, "iris.csv"),
                   minibatch_size=4, device="cpu")
assert len(ex.train()) == 2
leaked = sorted(m for m in sys.modules if _blocked(m))
assert not leaked, leaked
print("trained")
'''
    out = subprocess.run(
        [sys.executable, "-c", code],
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"), cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "trained"


def test_mesh_slice_modules_isolated_and_the_worker_trains_on_a_mesh():
    """The mesh slice's modules (parallel/) are among those imported
    with JAX blocked above; with JAX blocked the worker given a mesh
    starts its own one-rank gloo group, trains the MoE LM through
    SpmdTrainer on the CPU and reports the mesh in its telemetry, and a
    sparse model given a mesh trains through the sparse SPMD trainer
    (train/sparse_spmd.py, among the modules imported with JAX blocked,
    as are the multi-process runtime and the lockstep trainer)."""
    modules = _port_modules()
    for name in ("parallel", "parallel.mesh", "parallel.sharding",
                 "parallel.collectives", "parallel.dense_plane",
                 "parallel.spmd_trainer", "parallel.multihost",
                 "parallel.multihost_trainer", "train.sparse_spmd"):
        assert "elasticdl_tpu_torch." + name in modules, name
    code = _BLOCK + r'''
import sys
import numpy as np
import torch
from elasticdl_tpu_torch.common.args import parse_worker_args
from elasticdl_tpu_torch.data.readers import RecordIODataReader
from elasticdl_tpu_torch.parallel.mesh import parse_mesh_spec
from elasticdl_tpu_torch.parallel.spmd_trainer import SpmdTrainer
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.worker.worker import Worker
class Master:
    worker_id = 0
    telemetry_provider = None
    def get_comm_info(self):
        return pb.CommInfo(rank=0, world_size=1, mesh_epoch=0)
args = parse_worker_args(["--model_zoo", "m", "--master_addr", "a:1",
                          "--worker_id", "0", "--mesh", "dp=1"])
worker = Worker(Master(), "elasticdl_tpu_torch.models.moe_transformer",
                RecordIODataReader(data_dir="/nonexistent"),
                minibatch_size=4, device="cpu",
                model_params="vocab_size=64;num_layers=2;num_heads=2;"
                             "embed_dim=32;num_experts=2",
                mesh_config=parse_mesh_spec(args.mesh))
assert isinstance(worker.trainer, SpmdTrainer), type(worker.trainer)
assert torch.distributed.is_initialized()
assert worker.trainer.model.mesh is worker.trainer.mesh
tokens = np.random.RandomState(0).randint(0, 64, (4, 16)).astype(np.int32)
batch = {"features": tokens, "labels": tokens,
         "_mask": np.ones(4, np.float32)}
state, loss = worker.trainer.train_step(None, batch)
assert np.isfinite(float(loss))
blob = worker._telemetry_blob()
assert blob.mesh_shape == "dp=1" and blob.collective_bytes_per_step == 0.0
from elasticdl_tpu_torch.train.sparse_spmd import SparseSpmdTrainer
sparse = Worker(Master(), "elasticdl_tpu_torch.models.deepfm",
                RecordIODataReader(data_dir="/nonexistent"), device="cpu",
                ps_addrs=["localhost:1", "localhost:2"],
                mesh_config=parse_mesh_spec("dp=1"))
assert isinstance(sparse.trainer, SparseSpmdTrainer), type(sparse.trainer)
assert sparse.trainer.mesh_shape_str == ""
torch.distributed.destroy_process_group()
leaked = sorted(m for m in sys.modules if _blocked(m))
assert not leaked, leaked
print("trained")
'''
    out = subprocess.run(
        [sys.executable, "-c", code],
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"), cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "trained"


def test_long_context_slice_modules_isolated_and_train_with_jax_blocked():
    """The long-context slice's modules (ring and Ulysses attention, the
    pipeline and its two zoo models) are among those imported with JAX
    blocked above; with JAX blocked the worker given a mesh builds the
    zoo pipeline_transformer over it and trains it through SpmdTrainer
    on the CPU, and the TransformerLM's ring attention runs."""
    modules = _port_modules()
    for name in ("ops.ring_attention", "parallel.pipeline",
                 "models.pipeline_transformer", "models.pipeline_mlp"):
        assert "elasticdl_tpu_torch." + name in modules, name
    code = _BLOCK + r'''
import sys
import numpy as np
import torch
from elasticdl_tpu_torch.data.readers import RecordIODataReader
from elasticdl_tpu_torch.models import transformer
from elasticdl_tpu_torch.parallel.mesh import parse_mesh_spec
from elasticdl_tpu_torch.parallel.spmd_trainer import SpmdTrainer
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.worker.worker import Worker
class Master:
    worker_id = 0
    telemetry_provider = None
    def get_comm_info(self):
        return pb.CommInfo(rank=0, world_size=1, mesh_epoch=0)
worker = Worker(Master(), "elasticdl_tpu_torch.models.pipeline_transformer",
                RecordIODataReader(data_dir="/nonexistent"),
                minibatch_size=4, device="cpu",
                model_params="vocab_size=64;num_layers=2;num_heads=2;"
                             "embed_dim=32;num_microbatches=2",
                mesh_config=parse_mesh_spec("dp=1"))
assert isinstance(worker.trainer, SpmdTrainer), type(worker.trainer)
assert worker.trainer.model.mesh is worker.trainer.mesh
tokens = np.random.RandomState(0).randint(0, 64, (4, 16)).astype(np.int32)
batch = {"features": tokens, "labels": tokens,
         "_mask": np.ones(4, np.float32)}
state, loss = worker.trainer.train_step(None, batch)
assert np.isfinite(float(loss))
model = transformer.TransformerLM(vocab_size=64, num_layers=1, num_heads=2,
                                  embed_dim=32, attention_impl="ring")
assert model(torch.from_numpy(tokens)).shape == (4, 16, 64)
torch.distributed.destroy_process_group()
leaked = sorted(m for m in sys.modules if _blocked(m))
assert not leaked, leaked
print("trained")
'''
    out = subprocess.run(
        [sys.executable, "-c", code],
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"), cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "trained"


def test_cluster_slice_modules_isolated_and_the_cli_submits_with_jax_blocked():
    """The cluster and CLI slice's eight modules are among those imported
    with JAX blocked above; with JAX and the JAX package blocked,
    ``edl-torch train --dry_run`` prints the master pod naming the port's
    master, a submission through an api object creates that pod without
    importing yaml, and the pod manager that master builds starts its PS
    and worker pods, running the port's mains."""
    modules = _port_modules()
    for name in ("k8s.api", "k8s.client", "k8s.instance_manager",
                 "k8s.job_monitor", "k8s.pod_manager", "client.args",
                 "client.api", "client.main"):
        assert "elasticdl_tpu_torch." + name in modules, name
    code = _BLOCK + r'''
import contextlib, io, sys
from elasticdl_tpu_torch.client import api, main
from elasticdl_tpu_torch.common.args import parse_master_args
from elasticdl_tpu_torch.master.main import build_master
argv = ["train", "--job_name=iso", "--image_name=img",
        "--model_zoo=elasticdl_tpu_torch.models.deepfm",
        "--num_ps_pods=1", "--num_workers=1", "--envs=EDL_DEVICE=cpu"]
class Api:
    namespace = "default"
    def __init__(self):
        self.pods, self.services = {}, {}
    def create_pod(self, manifest):
        self.pods[manifest["metadata"]["name"]] = manifest
        return manifest
    def create_service(self, manifest):
        self.services[manifest["metadata"]["name"]] = manifest
        return manifest
    def watch_pods(self, label_selector=None, timeout_seconds=None):
        return iter(())
    def patch_pod_labels(self, name, labels):
        pass
fake = Api()
manifest = api.train(main.build_parser().parse_args(argv), api=fake)
assert "yaml" not in sys.modules
out = io.StringIO()
with contextlib.redirect_stdout(out):
    main.main(argv + ["--dry_run"])
assert "elasticdl_tpu_torch.master.main" in out.getvalue()
command = manifest["spec"]["containers"][0]["command"]
assert command[:3] == ["python", "-m", "elasticdl_tpu_torch.master.main"]
args = parse_master_args(command[3:] + ["--port=0"])
master = build_master(args, api=fake)
master.prepare()
try:
    commands = {n: p["spec"]["containers"][0]["command"][2]
                for n, p in fake.pods.items()}
finally:
    master.stop()
assert commands == {
    "elasticdl-iso-master": "elasticdl_tpu_torch.master.main",
    "elasticdl-iso-ps-0": "elasticdl_tpu_torch.ps.server",
    "elasticdl-iso-worker-0": "elasticdl_tpu_torch.worker.main"}, commands
leaked = sorted(m for m in sys.modules if _blocked(m))
assert not leaked, leaked
print("submitted")
'''
    out = subprocess.run(
        [sys.executable, "-c", code],
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"), cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "submitted"
