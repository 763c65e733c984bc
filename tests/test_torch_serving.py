"""Port's serving role against the JAX package.

An export written by the JAX package's own ``export_train_state`` is
served through the port's engine, servicer and client over real gRPC on
the CPU; the answers must match JAX ``make_eval_step`` on the same rows
and equal the port's ``ServingModel.predict`` bit for bit. The
admission-control cases mirror tests/test_serving.py, the wire is
checked both ways against the JAX ``tensor_utils`` (bf16 included), and
the role entry point runs as a subprocess through a SIGTERM drain.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import grpc
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from elasticdl_tpu.common import tensor_utils as jax_tensor_utils
from elasticdl_tpu.models.transformer import TransformerLM as JaxLM
from elasticdl_tpu.serve.client import ServeClient as JaxServeClient
from elasticdl_tpu.train.export import export_train_state
from elasticdl_tpu.train.step_fns import make_eval_step
from elasticdl_tpu.train.train_state import TrainState
from elasticdl_tpu_torch.common import tensor_utils as port_tensor_utils
from elasticdl_tpu_torch.common.grpc_utils import build_server, find_free_port
from elasticdl_tpu_torch.proto.services import add_serve_servicer_to_server
from elasticdl_tpu_torch.serve.batcher import (
    DeadlineExpired,
    Draining,
    MicroBatcher,
    QueueFull,
)
from elasticdl_tpu_torch.serve.client import ServeClient
from elasticdl_tpu_torch.serve.engine import ServingEngine
from elasticdl_tpu_torch.serve.servicer import ServeServicer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps these small-shape tests from oversubscribing
# the host's cores under other files' timing-sensitive tests
torch.set_num_threads(1)
ZOO = "elasticdl_tpu_torch.models.transformer"
WIDTHS = dict(vocab_size=256, num_layers=2, num_heads=2, embed_dim=128)
MODEL_PARAMS = ";".join("%s=%d" % kv for kv in WIDTHS.items())
SEQ = 64
MAX_BATCH = 4
STEP = 5

# fp32: same math, other summation order (see test_torch_transformer)
FP32_ATOL = 5e-5
# bf16 compute: one bf16 ulp at |logit| < 8 is 0.031; 3 ulps at the max
BF16_ATOL = 0.1


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    """A JAX TransformerLM exported by the JAX package, plus its eval
    forward for reference answers."""
    model = JaxLM(**WIDTHS)
    params = model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32)
    )["params"]
    state = TrainState(
        step=jnp.asarray(STEP, jnp.int32), params=params, model_state={},
        opt_state=(),
    )
    path = str(tmp_path_factory.mktemp("jax-export"))
    export_train_state(state, path)
    return model, state, path


def _tokens(rows, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, WIDTHS["vocab_size"], size=(rows, SEQ)).astype(
        np.int32
    )


def _jax_eval(model, state, tokens, compute_dtype=None):
    padded = np.zeros((MAX_BATCH, SEQ), np.int32)
    padded[: len(tokens)] = tokens
    out = jax.jit(make_eval_step(model, compute_dtype))(state, padded)
    return np.asarray(out.astype(jnp.float32))[: len(tokens)]


def _engine(export_dir, **kw):
    kw.setdefault("max_batch", MAX_BATCH)
    kw.setdefault("max_delay_ms", 2.0)
    kw.setdefault("deadline_ms", 30000.0)
    kw.setdefault("watch_secs", 30.0)
    return ServingEngine(
        ZOO, export_dir, model_params=MODEL_PARAMS, device="cpu", **kw
    ).start(block=True)


def _serve(engine):
    server = build_server()
    add_serve_servicer_to_server(ServeServicer(engine), server)
    port = find_free_port()
    server.add_insecure_port("[::]:%d" % port)
    server.start()
    return server, "localhost:%d" % port


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_served_outputs_match_jax_eval_step(jax_export, compute_dtype):
    model, state, path = jax_export
    engine = _engine(path, compute_dtype=compute_dtype)
    server, addr = _serve(engine)
    tokens = _tokens(3)  # a partial batch: padded to MAX_BATCH
    try:
        with ServeClient(addr) as client:
            info = client.model_info()
            assert info["loaded"] and info["step"] == STEP
            assert info["max_batch"] == MAX_BATCH
            outputs, step, stamp = client.predict(tokens)
        assert step == STEP and stamp == engine.model.stamp
        served = outputs["output"]
        assert served.shape == (3, SEQ, WIDTHS["vocab_size"])
        # the serving contract: the wire answer IS the model's predict
        direct = engine.model.predict(torch.from_numpy(tokens), 3)["output"]
        assert served.dtype == direct.dtype
        assert torch.equal(served, direct)
        expected = _jax_eval(
            model, state, tokens,
            jnp.bfloat16 if compute_dtype else None,
        )
        if compute_dtype is None:
            assert served.dtype == torch.float32
            np.testing.assert_allclose(
                served.numpy(), expected, atol=FP32_ATOL, rtol=1e-5
            )
        else:
            assert served.dtype == torch.bfloat16
            assert np.abs(served.float().numpy() - expected).max() <= BF16_ATOL
            # a JAX client reads the port's bf16 answer through ml_dtypes
            jax_client = JaxServeClient(addr)
            try:
                jax_out, jax_step, _ = jax_client.predict(tokens)
            finally:
                jax_client.close()
            assert jax_step == STEP
            assert jax_out["output"].dtype == ml_dtypes.bfloat16
            np.testing.assert_array_equal(
                jax_out["output"].view(np.int16),
                served.view(torch.int16).numpy(),
            )
    finally:
        server.stop(0)
        engine.drain(timeout=5)


def test_concurrent_requests_form_one_batch_over_grpc(jax_export):
    model, state, path = jax_export
    engine = _engine(path, max_delay_ms=500.0)
    server, addr = _serve(engine)
    tokens = _tokens(MAX_BATCH, seed=1)
    results = {}
    # one connected channel shared by the request threads (gRPC channels
    # are thread-safe), so connection setup does not spread the arrivals
    client = ServeClient(addr)
    client.model_info()

    def one(i):
        results[i] = client.predict(tokens[i:i + 1])[0]["output"]

    try:
        threads = [
            threading.Thread(target=one, args=(i,)) for i in range(MAX_BATCH)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert sorted(results) == list(range(MAX_BATCH))
        # the 500 ms window gathered the concurrent requests into one
        # (or, under scheduler jitter, two) batches
        assert 1 <= engine.batcher.batches_total <= 2
        expected = _jax_eval(model, state, tokens)
        for i in range(MAX_BATCH):
            np.testing.assert_allclose(
                results[i].numpy()[0], expected[i], atol=FP32_ATOL, rtol=1e-5
            )
    finally:
        client.close()
        server.stop(0)
        engine.drain(timeout=5)


def test_unloaded_model_answers_failed_precondition(tmp_path):
    engine = ServingEngine(
        ZOO, str(tmp_path / "nothing"), model_params=MODEL_PARAMS,
        device="cpu", max_batch=4, watch_secs=30.0,
    ).start()
    server, addr = _serve(engine)
    try:
        with ServeClient(addr) as client:
            assert client.model_info()["loaded"] is False
            with pytest.raises(grpc.RpcError) as err:
                client.predict(np.zeros((1, SEQ), np.int32))
        assert err.value.code() == grpc.StatusCode.FAILED_PRECONDITION
    finally:
        server.stop(0)
        engine.drain(timeout=5)


# ---------------------------------------------------------------------------
# micro-batcher admission control (mirrors tests/test_serving.py)


def _swallow(batcher, x):
    try:
        batcher.submit(x, 1)
    except (QueueFull, DeadlineExpired, Draining):
        pass


def test_batcher_sheds_at_queue_depth():
    release = threading.Event()

    def runner(features, rows):
        release.wait(timeout=10)
        return {"output": torch.zeros(rows)}, 1, "s"

    batcher = MicroBatcher(
        runner, max_batch=4, max_delay_ms=1.0, queue_depth=2,
        default_deadline_ms=5000.0,
    )
    x = torch.zeros((1, 2))
    threads = [
        threading.Thread(target=_swallow, args=(batcher, x), daemon=True)
        for _ in range(8)
    ]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 5
    while batcher.shed_total == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert batcher.shed_total > 0  # queue_full sheds fired
    release.set()
    for t in threads:
        t.join(timeout=10)
    batcher.stop()


def test_batcher_sheds_past_deadline_not_late():
    served = []

    def runner(features, rows):
        served.append(rows)
        return {"output": torch.zeros(rows)}, 1, "s"

    # formation window 80 ms >> request budget 5 ms: by the time the
    # batch forms, the request is past its deadline and MUST be shed
    batcher = MicroBatcher(
        runner, max_batch=8, max_delay_ms=80.0, queue_depth=8,
        default_deadline_ms=1000.0,
    )
    with pytest.raises(DeadlineExpired):
        batcher.submit(torch.zeros((1, 2)), 1, deadline_secs=0.005)
    assert not served
    assert batcher.shed_total == 1
    batcher.stop()


def test_batcher_forms_one_batch_from_concurrent_requests():
    sizes = []

    def runner(features, rows):
        sizes.append(rows)
        return {"output": torch.zeros(rows)}, 1, "s"

    batcher = MicroBatcher(
        runner, max_batch=16, max_delay_ms=60.0, queue_depth=32,
        default_deadline_ms=5000.0,
    )
    results = []

    def one():
        results.append(batcher.submit(np.zeros((2, 3), np.float32), 2))

    threads = [threading.Thread(target=one) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(results) == 4
    for outputs, _, _ in results:
        assert outputs["output"].shape == (2,)
    assert sum(sizes) == 8 and len(sizes) <= 2, sizes
    assert batcher.batches_total == len(sizes)
    batcher.stop()


def test_mixed_schema_requests_never_cobatch():
    shapes = []

    def runner(features, rows):
        shapes.append(tuple(features.shape))
        return {"output": torch.zeros(rows)}, 1, "s"

    batcher = MicroBatcher(
        runner, max_batch=16, max_delay_ms=60.0, queue_depth=32,
        default_deadline_ms=5000.0,
    )
    results = []

    def one(width):
        results.append(batcher.submit(torch.zeros((2, width)), 2))

    threads = [
        threading.Thread(target=one, args=(w,)) for w in (3, 5, 3, 5)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(results) == 4  # nobody failed
    assert all(shape[1] in (3, 5) for shape in shapes), shapes
    batcher.stop()


def test_drain_rejects_new_admissions_and_flushes():
    def runner(features, rows):
        return {"output": torch.zeros(rows)}, 1, "s"

    batcher = MicroBatcher(
        runner, max_batch=4, max_delay_ms=1.0, queue_depth=8,
        default_deadline_ms=5000.0,
    )
    batcher.submit(torch.zeros((1, 2)), 1)
    batcher.drain(timeout=5)
    with pytest.raises(Draining):
        batcher.submit(torch.zeros((1, 2)), 1)


# ---------------------------------------------------------------------------
# wire interop


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int32", "int64"])
def test_blobs_interoperate_with_jax_tensor_utils(dtype):
    rng = np.random.RandomState(3)
    values = (rng.normal(size=(3, 5)) * 100).astype(np.float32)
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    array = values.astype(np_dtype)
    # JAX writes, port reads
    blob = jax_tensor_utils.ndarray_to_blob(array)
    tensor = port_tensor_utils.blob_to_tensor(blob)
    assert tensor.shape == (3, 5) and str(tensor.dtype) == "torch." + dtype
    # port writes, JAX reads: the same bytes under the same dtype name
    back = port_tensor_utils.tensor_to_blob(tensor)
    assert back.dtype == blob.dtype == dtype
    assert back.content == blob.content
    decoded = jax_tensor_utils.blob_to_ndarray(back)
    assert decoded.dtype == np_dtype
    np.testing.assert_array_equal(
        decoded.view(np.uint8), array.view(np.uint8)
    )


def test_bf16_blob_has_no_numpy_view_in_the_port():
    blob = port_tensor_utils.tensor_to_blob(torch.ones(2, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        port_tensor_utils.blob_to_ndarray(blob)
    empty = port_tensor_utils.tensor_to_blob(
        torch.ones((0, 3), dtype=torch.bfloat16)
    )
    assert port_tensor_utils.blob_to_tensor(empty).shape == (0, 3)


# ---------------------------------------------------------------------------
# the role entry point


def test_serve_main_subprocess_answers_then_drains_on_sigterm(jax_export):
    model, state, path = jax_export
    port = find_free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "elasticdl_tpu_torch.serve.main",
            "--device", "cpu", "--model_zoo", ZOO,
            "--model_params", MODEL_PARAMS, "--export_dir", path,
            "--port", str(port), "--max_batch", str(MAX_BATCH),
            "--deadline_ms", "30000",
        ],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    )
    try:
        deadline = time.monotonic() + 90
        while True:
            # a fresh channel per probe: a channel that failed to
            # connect before the server bound sits out gRPC's
            # reconnect backoff instead of dialing again
            with ServeClient("localhost:%d" % port) as client:
                try:
                    if client.model_info()["loaded"]:
                        tokens = _tokens(1, seed=2)
                        outputs, step, _ = client.predict(tokens)
                        break
                except grpc.RpcError:
                    pass
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < deadline, "serve role never loaded"
            time.sleep(0.2)
        assert step == STEP
        np.testing.assert_allclose(
            outputs["output"].numpy(), _jax_eval(model, state, tokens),
            atol=FP32_ATOL, rtol=1e-5,
        )
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        log = proc.stdout.read()
        assert rc == 0, log
        assert "serve drained (sigterm)" in log, log
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_export_hot_swap_zero_failed_requests(jax_export, tmp_path):
    """A newer export landing mid-traffic is loaded, warmed and swapped
    in by the watcher; no request fails across the swap."""
    model, state, path = jax_export
    export_dir = str(tmp_path / "export")
    export_train_state(state, export_dir)
    engine = _engine(export_dir, watch_secs=0.1)
    server, addr = _serve(engine)
    tokens = _tokens(1, seed=4)
    steps, failures = [], []
    stop = threading.Event()

    def traffic():
        with ServeClient(addr) as client:
            while not stop.is_set():
                try:
                    steps.append(client.predict(tokens)[1])
                except grpc.RpcError as e:
                    failures.append(e.code())

    worker = threading.Thread(target=traffic)
    try:
        worker.start()
        deadline = time.monotonic() + 30
        while not steps and time.monotonic() < deadline:
            time.sleep(0.01)
        export_train_state(state.replace(step=state.step + 7), export_dir)
        while engine.swaps == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert engine.swaps == 1
        seen = len(steps)
        while len(steps) < seen + 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        stop.set()
        worker.join(timeout=30)
        assert not worker.is_alive()
        assert not failures, failures
        assert steps[0] == STEP and steps[-1] == STEP + 7
        with ServeClient(addr) as client:
            assert client.model_info()["step"] == STEP + 7
    finally:
        stop.set()
        server.stop(0)
        engine.drain(timeout=5)


def test_export_rewritten_in_place_swaps_once_to_the_whole_bundle(
        jax_export, tmp_path):
    """The exporter rewrites model.npz, then manifest.json. A publisher
    descheduled between the two (as under a loaded host) leaves a new
    npz described by the old manifest for many watch ticks; the watcher
    must not swap to that torn bundle, only to the whole new one, once.
    (Before the fix the engine swapped 5 -> 5 on the torn bundle, then
    5 -> 12, and the hot-swap test above saw step 5 after its swap.)"""
    import shutil

    model, state, path = jax_export
    export_dir = str(tmp_path / "export")
    export_train_state(state, export_dir)
    staged = str(tmp_path / "staged")
    export_train_state(state.replace(step=state.step + 7), staged)
    engine = _engine(export_dir, watch_secs=0.05)
    try:
        first = engine.model.stamp
        shutil.copyfile(os.path.join(staged, "model.npz"),
                        os.path.join(export_dir, "model.npz"))
        time.sleep(0.5)  # ten watch ticks with the torn bundle on disk
        assert engine.swaps == 0
        assert engine.model.stamp == first
        shutil.copyfile(os.path.join(staged, "manifest.json"),
                        os.path.join(export_dir, "manifest.json"))
        deadline = time.monotonic() + 30
        while engine.swaps == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(0.3)  # a second swap would land within a few ticks
        assert engine.swaps == 1
        assert engine.model.step == STEP + 7
    finally:
        engine.drain(timeout=5)


def test_export_copied_manifest_first_loads_and_takes_its_npz(
        jax_export, tmp_path, monkeypatch):
    """A bundle copied manifest.json first is complete: the engine loads
    it. Copied that way over the active bundle, the engine first swaps
    to the new manifest over the old npz (a torn bundle, as the
    reference does); the new npz then sits under the manifest the active
    version was read with, waits ``REWRITE_SETTLE_SECS`` for a manifest
    that never comes, and swaps in."""
    import shutil

    from elasticdl_tpu_torch.serve import engine as engine_mod
    from elasticdl_tpu_torch.serve.model import export_signature

    monkeypatch.setattr(engine_mod, "REWRITE_SETTLE_SECS", 0.3)
    model, state, path = jax_export
    staged = {}
    for name, step in (("a", state.step), ("b", state.step + 7)):
        staged[name] = str(tmp_path / name)
        export_train_state(state.replace(step=step), staged[name])
    export_dir = str(tmp_path / "export")
    os.makedirs(export_dir)

    def copy(src, name):
        shutil.copyfile(os.path.join(src, name),
                        os.path.join(export_dir, name))
        time.sleep(0.01)  # mtimes apart on a coarse filesystem clock

    copy(staged["a"], "manifest.json")
    copy(staged["a"], "model.npz")
    engine = _engine(export_dir, watch_secs=0.05)
    try:
        assert engine.model.step == STEP
        assert engine.model.stamp == export_signature(export_dir)
        copy(staged["b"], "manifest.json")
        deadline = time.monotonic() + 30
        while engine.swaps == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert engine.swaps == 1
        copy(staged["b"], "model.npz")
        while (engine.model.stamp != export_signature(export_dir)
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert engine.model.stamp == export_signature(export_dir)
        assert engine.swaps == 2
        assert engine.model.step == STEP + 7
    finally:
        engine.drain(timeout=5)
