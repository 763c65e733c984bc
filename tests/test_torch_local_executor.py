"""The port's local-training entry point end to end on the CPU.

``LocalExecutor(..., device="cpu")`` trains a small zoo TransformerLM
(vocab 256, 2 layers, 2 heads, d 128, S 128) over RecordIO files of
token Examples made with numpy from a seed; its per-step losses equal a
``TorchTrainer`` fed the same batches from the same weights. The trained
state exports to the shared bundle, which the JAX package loads and
serves with the same logits, and which the port's ``ServingModel``
serves with the same outputs as ``eval_step``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.models import transformer as jax_zoo
from elasticdl_tpu.train import export as jax_export
from elasticdl_tpu_torch.data import recordio
from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.data.pipeline import Dataset
from elasticdl_tpu_torch.models import transformer as port_zoo
from elasticdl_tpu_torch.models.registry import get_model_spec
from elasticdl_tpu_torch.serve.model import ServingModel
from elasticdl_tpu_torch.train.export import export_train_state
from elasticdl_tpu_torch.train.local_executor import LocalExecutor
from elasticdl_tpu_torch.worker.trainer import TorchTrainer

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps these small-shape tests from oversubscribing
# the host's cores under other files' timing-sensitive tests
torch.set_num_threads(1)

ZOO = "elasticdl_tpu_torch.models.transformer"
WIDTHS = dict(vocab_size=256, num_layers=2, num_heads=2, embed_dim=128)
MODEL_PARAMS = ";".join("%s=%d" % kv for kv in sorted(WIDTHS.items()))
SEQ = 128
# fp32 logits of the same weights through the flax model (xla
# attention) and the port's (flash path, plain versions on the CPU):
# summation order and libm only (tests/test_torch_transformer.py
# measured 4.3e-6 on logits of ~4.5).
LOGITS_ATOL = 5e-5


def _write_tokens(directory, n_files=2, per_file=7, seed=0):
    rng = np.random.RandomState(seed)
    os.makedirs(directory, exist_ok=True)
    for i in range(n_files):
        recordio.write_records(
            os.path.join(directory, "part-%d.rec" % i),
            [encode_example({"tokens": rng.randint(
                0, WIDTHS["vocab_size"], size=SEQ).astype(np.int32)})
             for _ in range(per_file)],
        )
    return directory


def _executor(data, **kwargs):
    kwargs.setdefault("minibatch_size", 4)
    return LocalExecutor(ZOO, training_data=data, model_params=MODEL_PARAMS,
                         seed=3, device="cpu", **kwargs)


def test_losses_equal_torch_trainer_on_the_same_batches(tmp_path):
    data = _write_tokens(str(tmp_path / "train"))
    executor = _executor(data, num_epochs=2)
    # the batches the executor will see: 14 records -> 4 + 4 + 4 + 2
    # (padded) per epoch
    batches = list(executor._batches(executor._train_reader, "training"))
    assert [int(b["_mask"].sum()) for b in batches] == [4, 4, 4, 2]
    torch.manual_seed(3)
    twin = TorchTrainer(port_zoo.custom_model(**WIDTHS), port_zoo.loss,
                        port_zoo.optimizer(), device="cpu")
    state = None
    expected = []
    for _ in range(2):
        for batch in batches:
            state, loss = twin.train_step(state, batch)
            expected.append(float(loss))
    losses = executor.train()
    assert losses == expected
    assert executor.state.step == 8
    assert all(np.isfinite(losses))


def test_bf16_training_keeps_fp32_masters(tmp_path):
    data = _write_tokens(str(tmp_path / "train"), n_files=1, per_file=8)
    executor = _executor(data, compute_dtype="bfloat16")
    losses = executor.train()
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(p.dtype == torch.float32
               for p in executor.state.params.values())


def test_export_serves_on_both_packages(tmp_path):
    """A trained port state's bundle: the JAX package loads it and its
    TransformerLM gives the port's logits; the port's ServingModel
    serves exactly ``eval_step``'s outputs."""
    data = _write_tokens(str(tmp_path / "train"), n_files=1, per_file=8)
    executor = _executor(data, validation_data=data)
    executor.train()
    export_dir = str(tmp_path / "export")
    export_train_state(executor.state, export_dir)

    params, model_state, step = jax_export.load_exported(export_dir)
    assert step == 2 and model_state == {}
    batch = next(iter(executor._batches(executor._valid_reader, "eval")))
    tokens = batch["features"]
    expected = executor.trainer.eval_step(executor.state, batch)
    jax_logits = jax_zoo.TransformerLM(attention_impl="xla", **WIDTHS).apply(
        {"params": params}, jnp.asarray(tokens))
    np.testing.assert_allclose(np.asarray(jax_logits), expected,
                               atol=LOGITS_ATOL, rtol=0)

    served = ServingModel(
        get_model_spec(ZOO, model_params=MODEL_PARAMS), export_dir,
        max_batch=4, device="cpu",
    ).predict(tokens, 4)["output"]
    np.testing.assert_array_equal(served.numpy(), expected)

    summary = executor.evaluate()
    assert set(summary) == {"accuracy"} and 0.0 <= summary["accuracy"] <= 1
    predictions = executor.predict()
    assert [p.shape for p in predictions] == [(4, SEQ, 256), (4, SEQ, 256)]


def test_the_zoo_contract_matches_jax():
    """loss on the same logits, and the zoo optimizer's settings."""
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, 256, size=(3, 16)).astype(np.int32)
    logits = rng.normal(size=(3, 16, 256)).astype(np.float32)
    expected = jax_zoo.loss(jnp.asarray(tokens), jnp.asarray(logits))
    got = port_zoo.loss(torch.from_numpy(tokens), torch.from_numpy(logits))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-6)
    params = {"w": rng.normal(size=(4,)).astype(np.float32)}
    grads = {"w": rng.normal(size=(4,)).astype(np.float32)}
    jtx, ptx = jax_zoo.optimizer(), port_zoo.optimizer()
    jupdates, _ = jtx.update({"w": jnp.asarray(grads["w"])},
                             jtx.init({"w": jnp.asarray(params["w"])}),
                             {"w": jnp.asarray(params["w"])})
    pparams = {"w": torch.from_numpy(params["w"])}
    pupdates, _ = ptx.update({"w": torch.from_numpy(grads["w"])},
                             ptx.init(pparams), pparams)
    np.testing.assert_allclose(pupdates["w"].numpy(),
                               np.asarray(jupdates["w"]), rtol=1e-6)
    metric = port_zoo.eval_metrics_fn()["accuracy"]
    metric.update_state(tokens, logits)
    reference = jax_zoo.eval_metrics_fn()["accuracy"]
    reference.update_state(tokens, logits)
    assert metric.result() == reference.result()
    assert len(list(port_zoo.dataset_fn(Dataset.from_list([])))) == 0


def test_sparse_models_and_missing_contract_raise(tmp_path):
    """A module with sparse embedding specs trains through the sparse
    trainer over an in-process store; a module without the training
    contract raises."""
    from elasticdl_tpu_torch.ps.local_client import LocalPSClient
    from elasticdl_tpu_torch.train.sparse import SparseTrainer

    zoo = tmp_path / "zoo"
    zoo.mkdir()
    (zoo / "sparse_lm.py").write_text(
        "from elasticdl_tpu_torch.models.deepfm import *\n"
    )
    (zoo / "serving_only.py").write_text(
        "from elasticdl_tpu_torch.models.transformer import (\n"
        "    custom_model, params_from_flax)\n"
    )
    data = _write_tokens(str(tmp_path / "train"), n_files=1, per_file=4)
    executor = LocalExecutor(str(zoo / "sparse_lm.py"), training_data=data,
                             device="cpu")
    assert isinstance(executor.trainer, SparseTrainer)
    assert isinstance(executor.trainer.preparer._ps, LocalPSClient)
    with pytest.raises(ValueError, match="loss"):
        LocalExecutor(str(zoo / "serving_only.py"), training_data=data,
                      device="cpu")


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    data = _write_tokens(str(tmp_path / "train"), n_files=1, per_file=4)
    with pytest.raises(RuntimeError, match="cuda"):
        LocalExecutor(ZOO, training_data=data, model_params=MODEL_PARAMS)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchTrainer(port_zoo.custom_model(**WIDTHS), port_zoo.loss,
                     port_zoo.optimizer())


def test_jax_weights_train_identically_from_flax(tmp_path):
    """From flax-initialised weights carried over by params_from_flax,
    one executor step gives the loss the JAX step gives on the same
    batch (fp32, the same tolerance as the step parity tests)."""
    from elasticdl_tpu.train import step_fns as jax_steps
    from elasticdl_tpu.train import train_state as jax_ts

    data = _write_tokens(str(tmp_path / "train"), n_files=1, per_file=4)
    executor = _executor(data)
    batch = next(iter(executor._batches(executor._train_reader, "train")))
    jmodel = jax_zoo.TransformerLM(attention_impl="xla", **WIDTHS)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.asarray(batch["features"]))["params"]
    with torch.no_grad():
        executor.trainer._model.load_state_dict(
            port_zoo.params_from_flax(jax_export._flatten(
                jax.device_get(params))))
    tx = jax_zoo.optimizer()
    jstate = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               model_state={}, opt_state=tx.init(params))
    _, jloss = jax.jit(jax_steps.make_train_step(jmodel, jax_zoo.loss, tx))(
        jstate, batch)
    (loss,) = executor.train()
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
