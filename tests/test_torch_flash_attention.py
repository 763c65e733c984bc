"""Port's flash-attention forward (K4) against the JAX reference.

On the CPU the port's wrapper runs its plain version; it is held
against the JAX package's Pallas kernel ``_fwd`` in interpret mode (how
tests/test_attention_ops.py runs it on the CPU) and against both
packages' ``xla_attention``. The CUDA kernel itself runs only on the
card: tests/test_torch_cuda_kernels.py compares it with the plain
version there.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import attention as jax_attention
from elasticdl_tpu.ops import flash_attention as jax_flash
from elasticdl_tpu_torch.ops import attention as port_attention
from elasticdl_tpu_torch.ops import flash_attention as port_flash

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps these small-shape tests from oversubscribing
# the host's cores under other files' timing-sensitive tests
torch.set_num_threads(1)

# fp32 on both sides, same algorithm up to summation order (blockwise
# online softmax vs full softmax): agreement to a few fp32 ulps of O(1)
# values. 2e-5 is the repo's own flash-vs-xla tolerance
# (tests/test_attention_ops.py).
O_TOL = 2e-5
LSE_TOL = 1e-5


def _qkv(bh=4, seq=256, dim=64, seed=0):
    rng = np.random.RandomState(seed)
    return [
        (rng.normal(size=(bh, seq, dim)) * 0.5).astype(np.float32)
        for _ in range(3)
    ]


@pytest.mark.parametrize("dim", [64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_fwd_matches_jax_pallas_interpret(causal, dim):
    q, k, v = _qkv(dim=dim)
    scale = 1.0 / np.sqrt(dim)
    jo, jlse = jax_flash._fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal,
        128, 128, True,
    )
    po, plse = port_flash.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
    )
    assert po.dtype == torch.float32 and plse.shape == (4, 1, 256)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo),
                               atol=O_TOL, rtol=O_TOL)
    np.testing.assert_allclose(plse.numpy(), np.asarray(jlse),
                               atol=LSE_TOL, rtol=LSE_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_xla_attention_matches_jax_and_flash(causal):
    q, k, v = _qkv(bh=4, seq=128)
    shape = (2, 2, 128, 64)
    as_bhsd = lambda a: a.reshape(shape)
    expected = np.asarray(jax_attention.xla_attention(
        jnp.asarray(as_bhsd(q)), jnp.asarray(as_bhsd(k)),
        jnp.asarray(as_bhsd(v)), causal=causal,
    ))
    tq, tk, tv = (torch.from_numpy(as_bhsd(a)) for a in (q, k, v))
    got = port_attention.xla_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.numpy(), expected, atol=O_TOL, rtol=O_TOL)
    # the dispatcher's flash path (plain version on CPU) agrees too
    flash = port_attention.dot_product_attention(
        tq, tk, tv, causal=causal, impl="flash"
    )
    np.testing.assert_allclose(flash.numpy(), expected,
                               atol=O_TOL, rtol=O_TOL)


def test_cpu_tensors_take_plain_version_without_launching():
    q, k, v = (torch.from_numpy(a) for a in _qkv(bh=2, seq=64))
    before = port_flash.LAUNCHES
    o, lse = port_flash.flash_attention_fwd(q, k, v, causal=True)
    ro, rlse = port_flash.flash_attention_fwd_reference(q, k, v, causal=True)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert port_flash.LAUNCHES == before


def test_wrapper_rejects_mismatched_and_foreign_inputs():
    q = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError):
        port_flash.flash_attention_fwd(q, torch.zeros(2, 9, 64), q)
    meta = torch.zeros(2, 8, 64, device="meta")
    with pytest.raises(ValueError):
        port_flash.flash_attention_fwd(meta, meta, meta)
    with pytest.raises(ValueError):
        port_attention.dot_product_attention(
            q[None], q[None], q[None], impl="nope"
        )


def test_kernel_build_dir_in_checkout_and_installed(tmp_path, monkeypatch):
    """In a checkout kernels build under its git-ignored build/; a copy
    of the package outside a checkout (as pip installs it) builds under
    the user's cache, never beside site-packages."""
    import importlib.util

    from elasticdl_tpu_torch.ops import _build

    assert _build.BUILD_DIR == os.path.join(REPO, "build", "edl_kernels")
    installed = tmp_path / "site-packages" / "elasticdl_tpu_torch" / "ops"
    installed.mkdir(parents=True)
    (installed / "_build.py").write_text(open(_build.__file__).read())
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    spec = importlib.util.spec_from_file_location(
        "_installed_build", str(installed / "_build.py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert module.BUILD_DIR == str(
        tmp_path / "home" / ".cache" / "elasticdl_tpu_torch" / "kernels"
    )


def test_kernel_modules_import_without_nvcc_or_triton(tmp_path):
    """The wrapper and the build module import on a machine with no nvcc and
    no triton; nothing is built at import."""
    code = (
        "import sys; sys.modules['triton'] = None\n"
        "import os\n"
        "from elasticdl_tpu_torch.ops import _build, flash_attention\n"
        "assert _build.build_logs == {}\n"
        "assert flash_attention.LAUNCHES == 0\n"
        "if not os.path.exists('/usr/local/cuda/bin/nvcc'):\n"
        "    try:\n"
        "        _build.load('flash_fwd')\n"
        "    except RuntimeError as e:\n"
        "        assert 'nvcc not found' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('built without nvcc')\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    env.pop("CUDA_HOME", None)
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_first_forward_imports_no_dynamo(tmp_path):
    """The K4 op's first call in a new process imports no
    ``torch._dynamo`` (``torch.library.custom_op``'s kernels do: 3.7 s
    on a CPU, paid by a serving replica's first request)."""
    code = (
        "import sys, torch\n"
        "from elasticdl_tpu_torch.ops import attention\n"
        "q = torch.randn(1, 2, 16, 64)\n"
        "with torch.inference_mode():\n"
        "    attention.dot_product_attention(q, q, q, causal=True)\n"
        "print('torch._dynamo' in sys.modules)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
