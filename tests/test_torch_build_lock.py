"""The kernel build (``ops/_build.py``) runs under a cross-process
``flock``, on the CPU, with ``nvcc`` replaced by a stub script.

The stub checks, from its own process, whether the build directory's
lock file is held (a non-blocking ``flock`` that must fail), records
each call, and writes the "library". Processes started together build
each library once.
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_STUB = textwrap.dedent('''\
    #!{python}
    import fcntl, os, sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    with open(os.path.join(os.path.dirname(out), ".lock"), "w") as lock:
        try:
            fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
            held = "unlocked"
        except BlockingIOError:
            held = "locked"
    with open(os.environ["STUB_CALLS"], "a") as calls:
        calls.write("%s %s\\n" % (os.path.basename(sys.argv[-1]), held))
    time.sleep(float(os.environ.get("STUB_SLEEP", "0")))
    with open(out, "w") as lib:
        lib.write(held)
''')

_BUILD = textwrap.dedent('''\
    import sys
    from elasticdl_tpu_torch.ops import _build
    _build.BUILD_DIR = sys.argv[1]
    _build._nvcc = lambda: sys.argv[2]
    _build.build(sys.argv[3:])
    print("built")
''')


def _stub(tmp_path):
    path = tmp_path / "nvcc"
    path.write_text(_STUB.format(python=sys.executable))
    path.chmod(0o755)
    return str(path)


def test_nvcc_runs_under_the_build_lock(tmp_path, monkeypatch):
    from elasticdl_tpu_torch.ops import _build

    build_dir = str(tmp_path / "kernels")
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build, "_nvcc", lambda: _stub(tmp_path))
    monkeypatch.setenv("STUB_CALLS", str(tmp_path / "calls"))
    _build.build(["flash_fwd", "embedding_tier"])
    calls = sorted(open(tmp_path / "calls").read().split("\n")[:-1])
    assert calls == ["embedding_tier.cu locked", "flash_fwd.cu locked"]
    for name in ("flash_fwd", "embedding_tier"):
        with open(_build.library_path(name, build_dir=build_dir)) as lib:
            assert lib.read() == "locked"
    assert os.path.exists(os.path.join(build_dir, ".lock"))
    # built: a second build starts no nvcc, and frees the lock after
    _build.build(["flash_fwd"])
    assert len(open(tmp_path / "calls").read().split("\n")[:-1]) == 2


def test_processes_that_start_together_build_each_kernel_once(tmp_path):
    stub = _stub(tmp_path)
    build_dir = str(tmp_path / "kernels")
    env = dict(os.environ, PYTHONPATH=REPO, STUB_SLEEP="1",
               STUB_CALLS=str(tmp_path / "calls"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD, build_dir, stub, "embedding_tier",
         "flash_bwd"], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(3)]
    try:
        results = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, results):
        assert p.returncode == 0, err
        assert out.strip() == "built"
    calls = sorted(open(tmp_path / "calls").read().split("\n")[:-1])
    assert calls == ["embedding_tier.cu locked", "flash_bwd.cu locked"]
