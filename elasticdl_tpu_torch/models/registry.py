"""Model-zoo module contract loader (port of
elasticdl_tpu/models/registry.py).

A model-zoo module exports the JAX package's contract names with torch
types:

- ``custom_model()`` -> an ``nn.Module`` whose ``forward(features)``
  maps a batch to outputs
- ``params_from_flax(flat)`` -> its state_dict from the export bundle's
  flat flax names, params and ``batch_stats/...`` model state (port
  addition: the bundle format both packages share)
- ``loss(labels, predictions)`` -> per-sample loss vector (torch)
- ``optimizer()`` -> a ``train.optimizers.GradientTransformation``
- ``dataset_fn(dataset, mode, metadata)`` -> maps a pipeline.Dataset of
  raw records to a Dataset of (features, label) examples
- ``eval_metrics_fn()`` -> {name: train.metrics.Metric} (optional)
- ``sparse_embedding_specs()`` -> host-PS tables (optional; a model
  with them trains through ``train.sparse.SparseTrainer``)
- ``callbacks()`` -> list of ``train.callbacks.Callback`` (optional;
  the worker adds a ``SavedModelExporter`` when none is declared)
- ``PredictionOutputsProcessor`` -> class whose ``process(outputs,
  worker_id)`` takes each prediction batch's outputs and whose optional
  ``close()`` runs before the task is reported done (optional)
- ``ps_optimizer`` -> the PS's optimizer spec (optional; kept on the
  spec, read by no ported role yet: the reference's pod manager, which
  passes it to the PS pods, is not ported)
- ``sharding_rules()`` -> parallel/sharding.py rules on flax paths
  (optional; read by parallel/spmd_trainer.py)
- ``batch_spec()`` -> the batch's PartitionSpec (optional)
- ``mesh_config(num_devices)`` -> a parallel/mesh.py MeshConfig the
  worker trains through the SPMD trainer with when ``--mesh`` is not
  given (optional)

``symbol_overrides`` (the ``--loss``, ``--optimizer``, ``--dataset_fn``,
``--eval_metrics_fn``, ``--callbacks`` and
``--prediction_outputs_processor`` flags) names the module attribute
that plays a contract part, for modules whose exports use other names.

Serving reads only the first two, so a serving-only module may leave
out the training names; the trainers raise when one is missing.
"""

import ast
import functools
import importlib
import importlib.util
import os
import sys


class ModelSpec:
    def __init__(self, custom_model, params_from_flax, loss=None,
                 optimizer=None, dataset_fn=None, eval_metrics_fn=None,
                 sparse_embedding_specs=None, callbacks=None,
                 prediction_outputs_processor=None, ps_optimizer=None,
                 sharding_rules=None, batch_spec=None, mesh_config=None,
                 module=None):
        self.custom_model = custom_model
        # {flax name: array} -> state_dict (port addition: exports carry
        # the JAX package's flat flax names)
        self.params_from_flax = params_from_flax
        self.loss = loss
        self.optimizer = optimizer
        self.dataset_fn = dataset_fn
        self.eval_metrics_fn = eval_metrics_fn or (lambda: {})
        self.sparse_embedding_specs = sparse_embedding_specs
        self.callbacks = callbacks or (lambda: [])
        self.prediction_outputs_processor = prediction_outputs_processor
        # the PS's optimizer; its consumer, the reference's pod manager
        # (k8s/pod_manager.py), is not ported (ROADMAP Queue 1)
        self.ps_optimizer = ps_optimizer
        # the SPMD surface: partition rules, the batch's spec and a
        # model-chosen mesh (parallel/)
        self.sharding_rules = sharding_rules
        self.batch_spec = batch_spec
        self.mesh_config = mesh_config
        self.module = module

    def require_training(self):
        """Raise unless the module exports the training contract."""
        missing = [name for name in ("loss", "optimizer", "dataset_fn")
                   if getattr(self, name) is None]
        if missing:
            raise ValueError(
                "Model module %s does not define required %s for training"
                % (getattr(self.module, "__name__", self.module), missing)
            )


def parse_params_string(params: str) -> dict:
    """Parse 'k=v;k=v' strings; values are Python literals when
    possible, else strings."""
    result = {}
    for part in (params or "").split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError("Bad params segment %r" % part)
        key, value = part.split("=", 1)
        try:
            result[key.strip()] = ast.literal_eval(value.strip())
        except (ValueError, SyntaxError):
            result[key.strip()] = value.strip()
    return result


def load_module(module_path_or_name):
    """Import a model-zoo module by file path or dotted module name."""
    if os.path.exists(module_path_or_name):
        name = os.path.splitext(os.path.basename(module_path_or_name))[0]
        spec = importlib.util.spec_from_file_location(
            name, module_path_or_name
        )
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
        return module
    return importlib.import_module(module_path_or_name)


def _resolve(module, name, default_name=None, required=True):
    target = getattr(module, name, None)
    if target is None and default_name:
        target = getattr(module, default_name, None)
    if target is None and required:
        raise ValueError(
            "Model module %s does not define required %r"
            % (module.__name__, name)
        )
    return target


def get_model_spec(module_path_or_name, model_def="", model_params="",
                   symbol_overrides=None) -> ModelSpec:
    """Resolve the model-zoo contract.

    ``model_def``: when ``module_path_or_name`` is a directory, a dotted
    path inside it selecting the module file, optionally with a trailing
    segment naming the model factory. ``model_params``: a ``k=v;k=v``
    string of kwargs bound onto ``custom_model``.
    ``symbol_overrides``: {contract key: module attribute name}. A name
    given there that the module does not define is an error, even for
    an optional part: the user asked for it by name.
    """
    factory_name = None
    target = module_path_or_name
    if model_def:
        if not os.path.isdir(module_path_or_name):
            raise ValueError(
                "--model_def requires --model_zoo to be a directory, "
                "got %r" % (module_path_or_name,)
            )
        parts = model_def.split(".")
        candidate = os.path.join(module_path_or_name, *parts) + ".py"
        if os.path.exists(candidate):
            target = candidate
        elif len(parts) >= 2:
            # last segment names the model factory inside the module
            target = (
                os.path.join(module_path_or_name, *parts[:-1]) + ".py"
            )
            if not os.path.exists(target):
                raise ValueError(
                    "--model_def %r resolves to neither %s nor %s under "
                    "%s" % (
                        model_def, candidate, target, module_path_or_name,
                    )
                )
            factory_name = parts[-1]
        else:
            raise ValueError(
                "--model_def %r resolves to no module file (%s) under %s"
                % (model_def, candidate, module_path_or_name)
            )
    module = load_module(target)
    custom_model = _resolve(
        module, factory_name or "custom_model",
        None if factory_name else "model",
    )
    if model_params:
        custom_model = functools.partial(
            custom_model, **parse_params_string(model_params)
        )
    overrides = symbol_overrides or {}

    def optional(key, default_name=None):
        return _resolve(module, overrides.get(key) or default_name or key,
                        required=key in overrides)

    return ModelSpec(
        custom_model=custom_model,
        params_from_flax=_resolve(module, "params_from_flax"),
        loss=optional("loss"),
        optimizer=optional("optimizer"),
        dataset_fn=optional("dataset_fn"),
        eval_metrics_fn=optional("eval_metrics_fn"),
        sparse_embedding_specs=optional("sparse_embedding_specs"),
        callbacks=optional("callbacks"),
        prediction_outputs_processor=optional(
            "prediction_outputs_processor", "PredictionOutputsProcessor"),
        ps_optimizer=optional("ps_optimizer"),
        sharding_rules=optional("sharding_rules"),
        batch_spec=optional("batch_spec"),
        mesh_config=optional("mesh_config"),
        module=module,
    )
