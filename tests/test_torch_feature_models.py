"""The port's feature-column models, generators, CSV reader, regression
metrics and registry options against the JAX package's.

(a) ``data/gen``: every generator writes the same bytes as the
reference's for the same seed (mnist, census, frappe, heart), and
tests/test_data_gen.py's scenarios hold on the port. (b) census_dnn,
census_wide_deep, census_sqlflow_wide_deep and heart: each
``dataset_fn`` gives the same features bit for bit, and from the
reference's initial weights (carried across by ``params_from_flax``)
the forward and one step's gradients agree per leaf within a relative
L2 of 1e-5 (fp32 on both sides, other summation orders). (c)
``CSVDataReader`` gives the reference's shards and rows, and
tests/test_data_layer.py's CSV scenarios hold. (d) MeanSquaredError
and MeanAbsoluteError. (e) the registry's ``model_def``,
``model_params`` and ``symbol_overrides`` scenarios of
tests/test_model_zoo.py, ``ps_optimizer``, and the symbol-override
flags of every role.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from elasticdl_tpu.data import gen as ref_gen
from elasticdl_tpu.data import pipeline as ref_pipeline
from elasticdl_tpu.data import readers as ref_readers
from elasticdl_tpu.proto import elasticdl_tpu_pb2 as ref_pb
from elasticdl_tpu.train import metrics as ref_metrics
from elasticdl_tpu_torch.common import args as port_args
from elasticdl_tpu_torch.data import gen
from elasticdl_tpu_torch.data import pipeline
from elasticdl_tpu_torch.data.example import decode_example
from elasticdl_tpu_torch.data.readers import (
    CSVDataReader,
    RecordIODataReader,
    create_data_reader,
)
from elasticdl_tpu_torch.data.recordio import RecordReader, count_records
from elasticdl_tpu_torch.models.layers import params_to_flax
from elasticdl_tpu_torch.models.registry import get_model_spec
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.train import metrics as M

torch.set_num_threads(1)

# one step's gradients, per leaf: fp32 on both sides
GRAD_RTOL = 1e-5
OUT_RTOL, OUT_ATOL = 1e-5, 1e-6
FEATURE_MODELS = ("census_dnn", "census_wide_deep",
                  "census_sqlflow_wide_deep", "heart")


def make_task(shard, start, end):
    return pb.Task(task_id=1, shard_name=shard, start=start, end=end)


def _bytes(paths):
    out = []
    for path in paths:
        with open(path, "rb") as f:
            out.append(f.read())
    return out


# ------------------------------------------------------------ (a) data/gen
@pytest.mark.parametrize("name,kwargs", [
    ("mnist", dict(num_records=300, image_size=12, records_per_shard=128)),
    ("census", dict(num_records=300, records_per_shard=128, seed=3)),
    ("frappe", dict(num_records=200, records_per_shard=128)),
    ("heart", dict(num_records=200, seed=5)),
])
def test_generators_write_the_reference_bytes(tmp_path, name, kwargs):
    fn = "gen_%s_recordio" % name
    port = getattr(gen, fn)(str(tmp_path / "port"), **kwargs)
    ref = getattr(ref_gen, fn)(str(tmp_path / "ref"), **kwargs)
    assert [p.rsplit("/", 1)[1] for p in port] == [
        p.rsplit("/", 1)[1] for p in ref]
    assert _bytes(port) == _bytes(ref)


def test_convert_image_label_shards(tmp_path):
    images = np.zeros((2500, 8, 8), np.uint8)
    labels = np.arange(2500) % 10
    paths = gen.convert_image_label(
        str(tmp_path), images, labels, records_per_shard=1024
    )
    assert len(paths) == 3
    assert sum(count_records(p) for p in paths) == 2500
    with RecordReader(paths[-1]) as reader:
        example = decode_example(reader.read(0))
    assert example["image"].shape == (8, 8)
    assert example["image"].dtype == np.uint8
    ref = ref_gen.convert_image_label(str(tmp_path / "ref"), images, labels,
                                      records_per_shard=1024)
    assert _bytes(paths) == _bytes(ref)


def test_reader_sees_generated_shards(tmp_path):
    gen.gen_frappe_recordio(str(tmp_path), num_records=300,
                            records_per_shard=128)
    reader = RecordIODataReader(data_dir=str(tmp_path))
    shards = reader.create_shards()
    assert sum(count for _, count in shards.values()) == 300


def test_census_rows_match_model_schema(tmp_path):
    paths = gen.gen_census_recordio(str(tmp_path), num_records=64)
    with RecordReader(paths[0]) as reader:
        example = decode_example(reader.read(0))
    assert set(example) == {
        "age", "hours_per_week", "capital_gain", "capital_loss",
        "work_class", "marital_status", "education", "occupation",
        "relationship", "race", "sex", "native_country", "label",
    }
    from elasticdl_tpu_torch.data.census_schema import WORK_CLASS_VOCABULARY

    assert str(example["work_class"].reshape(())) in WORK_CLASS_VOCABULARY


def test_heart_schema(tmp_path):
    from elasticdl_tpu_torch.data.gen.converters import (
        HEART_CATEGORICAL,
        HEART_NUMERIC,
    )

    paths = gen.gen_heart_recordio(str(tmp_path), num_records=32)
    with RecordReader(paths[0]) as reader:
        example = decode_example(reader.read(0))
    for col in list(HEART_NUMERIC) + list(HEART_CATEGORICAL):
        assert col in example
    assert example["label"] in (0, 1)


def test_generated_mnist_is_learnable(tmp_path):
    from elasticdl_tpu_torch.train.local_executor import LocalExecutor

    train_dir = tmp_path / "train"
    gen.gen_mnist_recordio(str(train_dir), num_records=512, image_size=12,
                           records_per_shard=512)
    executor = LocalExecutor(
        "elasticdl_tpu_torch.models.mnist", training_data=str(train_dir),
        minibatch_size=64, num_epochs=3, device="cpu",
    )
    losses = executor.train()
    assert losses[-1] < losses[0] * 0.5


def test_generated_census_is_learnable(tmp_path):
    from elasticdl_tpu_torch.train.local_executor import LocalExecutor

    train_dir = tmp_path / "train"
    valid_dir = tmp_path / "valid"
    gen.gen_census_recordio(str(train_dir), num_records=2048, seed=0)
    gen.gen_census_recordio(str(valid_dir), num_records=256, seed=1)
    executor = LocalExecutor(
        "elasticdl_tpu_torch.models.census_wide_deep",
        training_data=str(train_dir), validation_data=str(valid_dir),
        minibatch_size=64, num_epochs=8, device="cpu",
    )
    executor.train()
    assert executor.evaluate()["auc"] > 0.75


# --------------------------------------------------- (b) the four models
def _records(tmp_path, name, n):
    maker = gen.gen_heart_recordio if name == "heart" else (
        gen.gen_census_recordio)
    (path,) = maker(str(tmp_path), num_records=n, seed=2)
    with RecordReader(path) as reader:
        return [bytes(r) for r in reader.read_range(0, n)]


def _flat(tree):
    return {name: np.array(value) for name, value in
            traverse_util.flatten_dict(tree, sep="/").items()}


def carried_model(name, features):
    """(the reference module, its params at PRNGKey(0), the port model
    holding them)."""
    ref_mod = importlib.import_module("elasticdl_tpu.models." + name)
    port_mod = importlib.import_module("elasticdl_tpu_torch.models." + name)
    reference = ref_mod.custom_model()
    params = jax.jit(reference.init)(
        jax.random.PRNGKey(0),
        {k: jnp.asarray(v) for k, v in features.items()})["params"]
    model = port_mod.custom_model()
    state = port_mod.params_from_flax(_flat(params))
    assert set(state) == {n for n, _ in model.named_parameters()}
    model.load_state_dict(state, strict=True)
    return ref_mod, reference, params, port_mod, model


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize("name", FEATURE_MODELS)
def test_feature_model_forward_and_gradients_match_reference(tmp_path, name):
    records = _records(tmp_path, name, 48)
    ref_mod = importlib.import_module("elasticdl_tpu.models." + name)
    port_mod = importlib.import_module("elasticdl_tpu_torch.models." + name)
    ref_batch = next(iter(ref_mod.dataset_fn(
        ref_pipeline.Dataset.from_list(records)).batch(48)))
    batch = next(iter(port_mod.dataset_fn(
        pipeline.Dataset.from_list(records)).batch(48)))
    assert set(batch["features"]) == set(ref_batch["features"])
    for key, value in ref_batch["features"].items():
        got = batch["features"][key]
        assert got.dtype == value.dtype, key
        np.testing.assert_array_equal(got, value, err_msg=key)
    np.testing.assert_array_equal(batch["labels"], ref_batch["labels"])
    features, labels = batch["features"], batch["labels"]
    ref_mod, reference, params, port_mod, model = carried_model(
        name, features)

    def ref_loss(p, f, y):
        logits = reference.apply({"params": p}, f)
        return ref_mod.loss(y, logits).mean(), logits

    (want_loss, want), want_grads = jax.jit(jax.value_and_grad(
        ref_loss, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in features.items()},
            jnp.asarray(labels))
    logits = model({k: torch.from_numpy(v) for k, v in features.items()})
    loss = port_mod.loss(torch.from_numpy(labels), logits).mean()
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               rtol=OUT_RTOL, atol=OUT_ATOL)
    assert abs(loss.item() - float(want_loss)) <= OUT_RTOL * abs(
        float(want_loss))
    got = params_to_flax({n: p.grad for n, p in model.named_parameters()})
    want_flat = _flat(want_grads)
    assert set(got) == set(want_flat)
    worst = {n: _rel_l2(got[n], want_flat[n]) for n in want_flat}
    assert max(worst.values()) <= GRAD_RTOL, worst


def test_census_sqlflow_group_extents_match_reference():
    from elasticdl_tpu.models import census_sqlflow_wide_deep as ref
    from elasticdl_tpu_torch.models import census_sqlflow_wide_deep as port

    wide, deep = port.build_columns()
    ref_wide, ref_deep = ref.build_columns()
    assert len(wide) == 2 and len(deep) == 3
    for got, want in zip(wide + deep, ref_wide + ref_deep):
        assert got.name == want.name
        assert got.table_shape == want.table_shape
        assert got.categorical.offsets == [
            int(o) for o in want.categorical.offsets]


# ------------------------------------------------------------- (c) CSV
def test_csv_reader_seeks_by_row(tmp_path):
    path = str(tmp_path / "d.csv")
    with open(path, "w") as f:
        f.write("a,b\n")
        for i in range(50):
            f.write("%d,%d\n" % (i, i * 2))
    reader = CSVDataReader(data_dir=path)
    shards = reader.create_shards()
    assert shards[path] == (0, 50)
    rows = list(reader.read_records(make_task(path, 48, 60)))
    assert rows == [["48", "96"], ["49", "98"]]
    assert reader.metadata.column_names == ["a", "b"]


def test_factory_dispatch(tmp_path):
    csv_path = str(tmp_path / "x.csv")
    open(csv_path, "w").write("a\n1\n")
    assert isinstance(create_data_reader(csv_path), CSVDataReader)
    rec_dir = tmp_path / "recs"
    rec_dir.mkdir()
    from elasticdl_tpu_torch.data import recordio

    recordio.write_records(str(rec_dir / "f.rec"), [b"z"])
    assert isinstance(create_data_reader(str(rec_dir)), RecordIODataReader)


def test_csv_shards_and_rows_match_reference(tmp_path):
    rng = np.random.RandomState(11)
    for i, n in enumerate((37, 5, 64)):
        with open(tmp_path / ("part-%d.csv" % i), "w") as f:
            f.write("x;y;label\n")
            for _ in range(n):
                f.write("%.3f;\"q;%d\";%d\n" % (rng.rand(), rng.randint(9),
                                               rng.randint(3)))
                if rng.rand() < 0.1:
                    f.write("\n")  # blank lines are no rows
    (tmp_path / "notes.txt").write_text("not a shard\n")
    port = create_data_reader(str(tmp_path), sep=";")
    ref = ref_readers.create_data_reader(str(tmp_path), sep=";")
    assert port.create_shards() == ref.create_shards()
    assert port.metadata.column_names == ref.metadata.column_names
    assert port.records_output_types is list
    for shard, (_, n) in port.create_shards().items():
        for start, end in ((0, n), (3, 9), (n - 1, n + 10)):
            got = list(port.read_records(make_task(shard, start, end)))
            want = list(ref.read_records(ref_pb.Task(
                task_id=1, shard_name=shard, start=start, end=end)))
            assert got == want


# ---------------------------------------------------------- (d) metrics
def test_mse_mae():
    mse = M.MeanSquaredError()
    mae = M.MeanAbsoluteError()
    labels = np.array([1.0, 2.0, 3.0])
    outputs = np.array([1.0, 1.0, 5.0])
    mse.update_state(labels, outputs)
    mae.update_state(labels, outputs)
    assert abs(mse.result() - (0 + 1 + 4) / 3) < 1e-9
    assert abs(mae.result() - (0 + 1 + 2) / 3) < 1e-9


def test_regression_metrics_match_reference():
    rng = np.random.RandomState(12)
    pairs = [(M.MeanSquaredError(), ref_metrics.MeanSquaredError()),
             (M.MeanAbsoluteError(), ref_metrics.MeanAbsoluteError())]
    for _ in range(4):
        labels = rng.normal(size=(7, 2)).astype(np.float32)
        outputs = rng.normal(size=(7, 2)).astype(np.float32)
        for port, ref in pairs:
            port.update_state(labels, outputs)
            ref.update_state(labels, outputs)
    for port, ref in pairs:
        assert port.result() == ref.result() and port.name == ref.name
        port.reset_states()
        assert port.result() == 0.0


# ---------------------------------------------------------- (e) registry
def _toy_zoo(tmp_path):
    zoo = tmp_path / "zoo" / "toy"
    zoo.mkdir(parents=True)
    (zoo / "toy_model.py").write_text(
        "from torch import nn\n"
        "from elasticdl_tpu_torch.models.layers import params_from_flax\n"
        "from elasticdl_tpu_torch.train.optimizers import create_optimizer\n"
        "class _M(nn.Module):\n"
        "    def __init__(self, hidden=4):\n"
        "        super().__init__()\n"
        "        self.hidden = hidden\n"
        "        self.Dense_0 = nn.Linear(2, hidden)\n"
        "    def forward(self, x):\n"
        "        return self.Dense_0(x)\n"
        "def custom_model(hidden=4):\n"
        "    return _M(hidden=hidden)\n"
        "def make_wide(hidden=4):\n"
        "    return _M(hidden=hidden * 2)\n"
        "def loss(labels, predictions):\n"
        "    return ((predictions - labels) ** 2).mean(dim=-1)\n"
        "def my_loss(labels, predictions):\n"
        "    return ((predictions - labels) ** 2).mean(dim=-1) * 2\n"
        "def optimizer():\n"
        "    return create_optimizer('SGD', learning_rate=0.1)\n"
        "def dataset_fn(dataset, mode, metadata):\n"
        "    return dataset\n"
        "ps_optimizer = {'opt_type': 'adagrad', 'lr': 0.1}\n"
    )
    return zoo


def test_model_def_and_model_params(tmp_path):
    zoo = _toy_zoo(tmp_path)
    # module path alone -> default custom_model factory
    spec = get_model_spec(str(tmp_path / "zoo"), model_def="toy.toy_model")
    assert spec.custom_model().hidden == 4
    # trailing segment names the factory; model_params binds kwargs
    spec = get_model_spec(
        str(tmp_path / "zoo"),
        model_def="toy.toy_model.make_wide",
        model_params="hidden=8",
    )
    assert spec.custom_model().hidden == 16
    # model_params works without model_def (a module path)
    spec = get_model_spec(str(zoo / "toy_model.py"), model_params="hidden=3")
    assert spec.custom_model().hidden == 3
    with pytest.raises(ValueError, match="directory"):
        get_model_spec(str(zoo / "toy_model.py"), model_def="x.y")
    with pytest.raises(ValueError, match="resolves to neither"):
        get_model_spec(str(tmp_path / "zoo"), model_def="toy.nope")


def test_model_def_single_segment_stays_inside_zoo(tmp_path):
    zoo = tmp_path / "models"
    zoo.mkdir()
    # a sibling OUTSIDE the zoo that a naive join would import
    (tmp_path / "models.py").write_text("custom_model = None\n")
    with pytest.raises(ValueError, match="no module file"):
        get_model_spec(str(zoo), model_def="custom_model")


def test_symbol_overrides(tmp_path):
    zoo = _toy_zoo(tmp_path)
    path = str(zoo / "toy_model.py")
    spec = get_model_spec(path, symbol_overrides={"loss": "my_loss"})
    assert spec.loss.__name__ == "my_loss"
    assert spec.ps_optimizer == {"opt_type": "adagrad", "lr": 0.1}
    # an explicitly named symbol that is missing errors even for an
    # otherwise optional part
    with pytest.raises(ValueError, match="my_callbacks"):
        get_model_spec(path, symbol_overrides={"callbacks": "my_callbacks"})
    assert get_model_spec(path).ps_optimizer is not None
    assert get_model_spec(
        "elasticdl_tpu_torch.models.iris_dnn").ps_optimizer is None


def test_symbol_override_flags_reach_every_role(tmp_path, monkeypatch):
    """The flags of the master and the worker, and the overrides the
    master, the worker, LocalExecutor and the serving engine resolve
    the contract with (each builds its spec through get_model_spec)."""
    from elasticdl_tpu.common import args as ref_args

    assert port_args.SYMBOL_OVERRIDE_KEYS == ref_args.SYMBOL_OVERRIDE_KEYS
    argv = ["--model_zoo", "m", "--loss", "my_loss", "--callbacks", "cb"]
    master = port_args.parse_master_args(argv)
    worker = port_args.parse_worker_args(
        argv + ["--master_addr", "x:1", "--worker_id", "0"])
    for args in (master, worker):
        assert port_args.symbol_overrides_from_args(args) == {
            "loss": "my_loss", "callbacks": "cb"}
    assert port_args.symbol_overrides_from_args(
        port_args.parse_master_args(["--model_zoo", "m"])) is None

    from elasticdl_tpu_torch.master import master as master_mod
    from elasticdl_tpu_torch.serve import engine as engine_mod
    from elasticdl_tpu_torch.train import local_executor
    from elasticdl_tpu_torch.worker import worker as worker_mod

    seen = []

    class Stop(Exception):
        pass

    def spy(*args, **kwargs):
        seen.append(kwargs.get("symbol_overrides"))
        raise Stop

    overrides = {"loss": "my_loss"}
    for module in (master_mod, engine_mod, local_executor, worker_mod):
        monkeypatch.setattr(module, "get_model_spec", spy)
    with pytest.raises(Stop):
        master_mod.Master("m", symbol_overrides=overrides)
    with pytest.raises(Stop):
        engine_mod.ServingEngine("m", str(tmp_path), device="cpu",
                                 symbol_overrides=overrides)
    with pytest.raises(Stop):
        local_executor.LocalExecutor("m", device="cpu",
                                     symbol_overrides=overrides)
    with pytest.raises(Stop):
        worker_mod.Worker(None, "m", None, device="cpu",
                          symbol_overrides=overrides)
    assert seen == [overrides] * 4
