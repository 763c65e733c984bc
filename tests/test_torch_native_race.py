"""Sanitizer gates for the port's native embedding store
(``elasticdl_tpu_torch/native``), as tests/test_native_race.py holds the
reference's: the store compiled with ``store_stress_test.cc`` (threads
hammering lookups with lazy row creation, pushes, wire-blob applies,
full and dirty exports, drops and version bumps over two tables) under
ThreadSanitizer with halt_on_error=1, and under AddressSanitizer with
UBSan. The asynchronous checkpoint thread exports dirty rows while
pushes land: this is its race gate. The binaries are built under the
git-ignored ``build/edl_store_stress/``.
"""

import functools
import os
import shutil
import subprocess
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO, "elasticdl_tpu_torch", "native")
STRESS_DIR = os.path.join(REPO, "build", "edl_store_stress")


@functools.lru_cache(maxsize=None)
def _sanitizer_available(flag):
    """g++ alone is not enough (libtsan and libasan ship apart on
    minimal images): probe with a tiny link, once per test run."""
    if shutil.which("g++") is None:
        return False
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cc")
        with open(src, "w") as f:
            f.write("int main() { return 0; }\n")
        probe = subprocess.run(["g++", flag, "-o", os.path.join(tmp, "probe"),
                                src], capture_output=True)
        return probe.returncode == 0


def _run_sanitized_stress(target):
    return subprocess.run(
        ["make", "-s", "-C", NATIVE_DIR, "STRESS_DIR=" + STRESS_DIR, target],
        capture_output=True, text=True, timeout=300)


def test_store_survives_tsan_stress():
    if not _sanitizer_available("-fsanitize=thread"):
        pytest.skip("no C++ toolchain with libtsan")
    result = _run_sanitized_stress("tsan")
    out = result.stdout + result.stderr
    assert result.returncode == 0, out
    assert "STRESS-OK" in result.stdout
    assert "WARNING: ThreadSanitizer" not in out
    assert os.path.exists(os.path.join(STRESS_DIR, "store_stress_tsan"))


def test_store_survives_asan_ubsan_stress():
    if not _sanitizer_available("-fsanitize=address,undefined"):
        pytest.skip("no C++ toolchain with libasan/libubsan")
    result = _run_sanitized_stress("asan")
    out = result.stdout + result.stderr
    assert result.returncode == 0, out
    assert "STRESS-OK" in result.stdout
    assert "ERROR: AddressSanitizer" not in out
    assert "runtime error:" not in out  # UBSan's report prefix
