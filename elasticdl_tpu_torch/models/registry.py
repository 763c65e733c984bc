"""Model-zoo module contract loader (port of
elasticdl_tpu/models/registry.py).

A model-zoo module exports the JAX package's contract names with torch
types: ``custom_model()`` -> an ``nn.Module`` whose ``forward(features)``
maps a batch to outputs, and ``params_from_flax(flat)`` -> its
state_dict from the export bundle's flat flax names (the bundle format
both packages share). That is all serving reads;
the training contract (``loss``, ``optimizer``, ``dataset_fn``, ...)
joins with the training slice.
"""

import ast
import functools
import importlib
import importlib.util
import os
import sys


class ModelSpec:
    def __init__(self, custom_model, params_from_flax, module=None):
        self.custom_model = custom_model
        # {flax name: array} -> state_dict (port addition: exports carry
        # the JAX package's flat flax names)
        self.params_from_flax = params_from_flax
        self.module = module


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


def get_model_spec(module_path_or_name, model_def="",
                   model_params="") -> ModelSpec:
    """Resolve the model-zoo contract.

    ``model_def``: when ``module_path_or_name`` is a directory, a dotted
    path inside it selecting the module file, optionally with a trailing
    segment naming the model factory. ``model_params``: a ``k=v;k=v``
    string of kwargs bound onto ``custom_model``.
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
    return ModelSpec(
        custom_model=custom_model,
        params_from_flax=_resolve(module, "params_from_flax"),
        module=module,
    )
