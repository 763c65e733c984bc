"""Build and load the hand-written CUDA kernels.

Each source under ``ops/csrc/`` (flash attention K4-K6, the device
tier's K1-K3) is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). Builds happen
at first use, from the package's own sources only, into
``<checkout>/build/edl_kernels/`` (git-ignored); a package installed
outside a checkout builds into ``~/.cache/elasticdl_tpu_torch/kernels/``
instead, since site-packages is often read-only and shared. The
library name carries a hash of the source and the flags, so an edited
source is rebuilt and never confused with a stale library. ``build()`` starts one
``nvcc`` per source, all at once, and waits for them together, under
an ``flock`` on ``<build dir>/.lock``: processes started together (a
worker and its siblings) build each library once, the later ones
finding it built when the lock comes free.

Nothing here runs at import: the CPU tests import every module of the
package on a machine with no ``nvcc`` and no card.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")


def build_dir(name):
    """``<checkout>/build/edl_<name>`` (git-ignored) when the package
    lies in a checkout, else ``~/.cache/elasticdl_tpu_torch/<name>``."""
    root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    if os.path.exists(os.path.join(root, "pyproject.toml")):
        return os.path.join(root, "build", "edl_" + name)
    return os.path.join(
        os.path.expanduser("~"), ".cache", "elasticdl_tpu_torch", name
    )


BUILD_DIR = build_dir("kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# kernel library name -> (source file, {C function: (argtypes, restype)})
_VP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNELS = {
    "flash_fwd": (
        "flash_fwd.cu",
        {
            "edl_flash_fwd": (
                # q, k, v, o, lse, bh, seq_q, seq_k, head_dim, is_bf16,
                # causal, sm_scale, stream
                [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT,
                 _INT, _FLOAT, _VP],
                _INT,
            ),
        },
    ),
    "flash_bwd": (
        "flash_bwd.cu",
        {
            "edl_flash_bwd_dq": (
                # q, k, v, do, lse, delta, dq, bh, seq_q, seq_k,
                # head_dim, is_bf16, causal, sm_scale, stream
                [_VP] * 7 + [_INT] * 6 + [_FLOAT, _VP],
                _INT,
            ),
            "edl_flash_bwd_dkv": (
                # q, k, v, do, lse, delta, dk, dv, bh, seq_q, seq_k,
                # head_dim, is_bf16, causal, sm_scale, stream
                [_VP] * 8 + [_INT] * 6 + [_FLOAT, _VP],
                _INT,
            ),
        },
    ),
    "embedding_tier": (
        "embedding_tier.cu",
        {
            # K1: table, slots, miss (or None), out, n, dim, table_rows,
            # pdl, stream
            "edl_tier_gather": ([_VP] * 4 + [_INT] * 4 + [_VP], _INT),
            # K2: rows, slot0, slot1, steps (each buffer but rows may be
            # None), slots, ins_rows (or None), n, dim, table_rows, pdl,
            # stream
            "edl_tier_insert_rows": ([_VP] * 6 + [_INT] * 4 + [_VP], _INT),
            # K3: grads, slots, rows, slot0, slot1, steps, n, dim,
            # table_rows, opt, lr, momentum, beta1, 1 - beta1, beta2,
            # 1 - beta2, eps, stream
            "edl_tier_scatter_apply": (
                [_VP] * 6 + [_INT] * 4 + [_FLOAT] * 7 + [_VP],
                _INT,
            ),
        },
    ),
}

_lock = threading.Lock()
_loaded = {}
# kernel name -> nvcc's stderr (ptxas register/shared-memory report)
build_logs = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        candidate = os.path.join(root, "bin", "nvcc") if root else ""
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are built on a machine with the CUDA toolkit"
    )


def library_path(name, source=None, build_dir=None):
    """Where kernel ``name``'s library is built: under ``build_dir``
    (BUILD_DIR), named by a hash of ``source`` (the package's own source
    of the kernel) and the flags."""
    source = source or os.path.join(_CSRC, KERNELS[name][0])
    digest = hashlib.sha256()
    with open(source, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(
        build_dir or BUILD_DIR,
        "lib%s-%s.so" % (name, digest.hexdigest()[:16]),
    )


def build(names=None):
    """Compile every kernel in ``names`` (default: all) that has no
    library yet, one nvcc each, started together. Returns the seconds
    spent. Raises with nvcc's output when a build fails."""
    names = list(KERNELS) if names is None else list(names)
    start = time.monotonic()
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
            # across processes: whoever holds the lock builds; the rest
            # wait, then find the libraries there
            fcntl.flock(lock, fcntl.LOCK_EX)
            _build_locked(names)
    return time.monotonic() - start


def _build_locked(names):
    pending = []
    for name in names:
        target = library_path(name)
        if os.path.exists(target):
            continue
        # build to a private name, then rename: a loader never sees a
        # half-written library
        tmp = "%s.%d.tmp" % (target, os.getpid())
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(_CSRC, KERNELS[name][0])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        pending.append((name, target, tmp, proc))
    failures = []
    for name, target, tmp, proc in pending:
        output, _ = proc.communicate()
        build_logs[name] = output
        if proc.returncode != 0:
            failures.append("%s (rc %d):\n%s" % (
                name, proc.returncode, output))
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))


def bind(path, name):
    """The library at ``path`` loaded with ctypes, its C functions typed
    as kernel ``name``'s."""
    lib = ctypes.CDLL(path)
    for fn_name, (argtypes, restype) in KERNELS[name][1].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load(name):
    """The ctypes library of kernel ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = bind(library_path(name), name)
    return lib
