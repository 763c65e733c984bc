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

_BLOCKER = r'''
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
