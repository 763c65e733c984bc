"""The port's serving fleet as live processes on the CPU.

``python -m elasticdl_tpu_torch.serve.router_main`` manages two port
``serve.main`` replicas of a narrow TransformerLM (2 layers, d 64,
``--device cpu``) over a versioned export root, under closed-loop
traffic from this process: spin-up, a SIGKILLed replica that costs no
request and is replaced by the autoscaler's floor, a canary that
promotes v2 and one that rolls back a poisoned v3, each journaled. Then
a replica managed outside the router leaves on the router's drain
directive through the exactly-once deregister ack, and a replica asked
for ``--device cuda`` on a host without a card refuses to start.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from elasticdl_tpu_torch.common.grpc_utils import (
    build_server,
    find_free_port,
)
from elasticdl_tpu_torch.proto.services import add_router_servicer_to_server
from elasticdl_tpu_torch.serve.client import ServeClient
from elasticdl_tpu_torch.serve.model import export_signature
from elasticdl_tpu_torch.serve.router import RouterServicer
from elasticdl_tpu_torch.train.export import export_state_dict
from tests.test_utils import load_journal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = "elasticdl_tpu_torch.models.transformer"
WIDTHS = dict(vocab_size=256, num_layers=2, num_heads=2, embed_dim=64)
MODEL_PARAMS = ";".join("%s=%d" % kv for kv in sorted(WIDTHS.items()))
SEQ = 16
FLEET_ENV = {
    "EDL_ROUTER_HEARTBEAT_SECS": "1",
    "EDL_ROUTER_REPLICA_TIMEOUT_SECS": "4",
    "EDL_CANARY_FRACTION": "0.5",
    "EDL_CANARY_MIN_REQUESTS": "15",
    "EDL_CANARY_TIMEOUT_SECS": "600",
    # outlasts a replica's cold start here (3-4 s): no spawn storm
    "EDL_SERVE_SCALE_COOLDOWN_SECS": "12",
}


def _weights(rng):
    """Flax-named weights of the narrow LM; the LayerNorms at 1 / 0."""
    d, heads, vocab = (WIDTHS["embed_dim"], WIDTHS["num_heads"],
                       WIDTHS["vocab_size"])

    def normal(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(
            np.float32)

    flat = {"wte/embedding": normal((vocab, d), 2500.0),
            "ln_f/scale": np.ones(d, np.float32),
            "ln_f/bias": np.zeros(d, np.float32),
            "lm_head/kernel": normal((d, vocab), d)}
    for i in range(WIDTHS["num_layers"]):
        b = "block_%d/" % i
        for ln in ("ln_attn", "ln_mlp"):
            flat[b + ln + "/scale"] = np.ones(d, np.float32)
            flat[b + ln + "/bias"] = np.zeros(d, np.float32)
        for proj in ("query", "key", "value"):
            flat[b + "attn/%s/kernel" % proj] = normal(
                (d, heads, d // heads), d)
        flat[b + "attn/out_proj/kernel"] = normal((heads, d // heads, d), d)
        flat[b + "mlp_up/kernel"] = normal((d, 4 * d), d)
        flat[b + "mlp_down/kernel"] = normal((4 * d, d), 4 * d)
    return flat


def _poisoned(flat):
    """Every logit lifted by 0.5: LayerNorm's centred output sums to 0
    over d, so ln_f's bias 1 times lm_head's added 0.5 / d is the whole
    shift, and the judge's clipped per-request mean moves bins."""
    d = WIDTHS["embed_dim"]
    out = dict(flat)
    out["ln_f/bias"] = np.ones(d, np.float32)
    out["lm_head/kernel"] = flat["lm_head/kernel"] + np.float32(0.5 / d)
    return out


def _kill_if_replica(pid):
    """SIGKILL ``pid`` if it is still a ``serve.main`` replica (the pid
    of an exited one may belong to another process by now)."""
    try:
        with open("/proc/%d/cmdline" % pid, "rb") as f:
            if b"elasticdl_tpu_torch.serve.main" not in f.read():
                return
        os.kill(pid, signal.SIGKILL)
    except OSError:
        pass


def _get_json(url):
    with urllib.request.urlopen(url, timeout=5) as reply:
        return json.loads(reply.read().decode())


def _wait(cond, what, timeout=90.0, procs=()):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for proc in procs:
            assert proc.poll() is None, "%s exited while waiting for %s" % (
                proc.args, what)
        try:
            got = cond()
        except OSError:
            got = None
        if got:
            return got
        time.sleep(0.1)
    raise AssertionError("no %s within %.0f s" % (what, timeout))


class _Traffic:
    """Closed-loop callers through one address: keys cycle over 1-32,
    every 8th request unkeyed; every outcome kept."""

    def __init__(self, addr, callers=2):
        self.addr = addr
        self.stop = threading.Event()
        self.lock = threading.Lock()
        self.steps, self.failures = [], []
        self.tokens = np.random.default_rng(1).integers(
            0, WIDTHS["vocab_size"], size=(64, SEQ), dtype=np.int32)
        self.threads = [threading.Thread(target=self._run, args=(c, callers))
                        for c in range(callers)]

    def _run(self, n, stride):
        with ServeClient(self.addr) as client:
            while not self.stop.is_set():
                key = 0 if n % 8 == 0 else 1 + n % 32
                try:
                    outputs, step, _ = client.predict(
                        self.tokens[n % 64][None], deadline_secs=60,
                        affinity_key=key)
                    assert np.isfinite(outputs["output"].numpy()).all()
                    with self.lock:
                        self.steps.append(step)
                except Exception as e:  # the test asserts there are none
                    with self.lock:
                        self.failures.append(repr(e))
                n += stride

    def __enter__(self):
        for t in self.threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        for t in self.threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in self.threads)


def test_fleet_survives_a_kill_promotes_and_rolls_back(tmp_path):
    root, events_dir, logs = (tmp_path / "exports", tmp_path / "events",
                              tmp_path / "replicas")
    for d in (root, events_dir, logs):
        d.mkdir()
    flat = _weights(np.random.default_rng(0))
    export_state_dict(flat, str(root / "v1"), step=1)
    rport, mport = find_free_port(), find_free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               EDL_EVENTS_DIR=str(events_dir), **FLEET_ENV)
    router_log = tmp_path / "router.log"
    log = router_log.open("w")
    router = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.serve.router_main",
         "--port", str(rport), "--min_replicas", "2", "--max_replicas", "3",
         "--export_root", str(root), "--replica_log_dir", str(logs),
         "--metrics_port", str(mport), "--replica_args",
         "--model_zoo %s --model_params %s --device cpu --max_batch 4 "
         "--max_delay_ms 2 --deadline_ms 60000 --watch_secs 0.2"
         % (ZOO, MODEL_PARAMS)],
        cwd=REPO, env=env, stdout=log,
        stderr=subprocess.STDOUT)
    routerz = "http://localhost:%d/routerz" % mport

    def fleet(cond):
        state = _get_json(routerz)
        return state if cond(state) else None

    def loaded(export, n=2):
        return lambda s: len(s["replicas"]) >= n and all(
            r["loaded_export"] == export for r in s["replicas"].values())

    try:
        first = sorted(_wait(lambda: fleet(loaded("v1")),
                             "two replicas on v1", procs=[router])
                       ["replicas"])
        with _Traffic("localhost:%d" % rport) as traffic:
            _wait(lambda: len(traffic.steps) >= 20, "first answers")
            victim = first[0]
            os.kill(int(victim.rsplit("-", 1)[1]), signal.SIGKILL)
            state = _wait(lambda: fleet(
                lambda s: victim not in s["replicas"]
                and len(s["replicas"]) >= 2
                and all(r["loaded_stamp"] for r in s["replicas"].values())),
                "the floor's replacement", procs=[router])
            replacement = sorted(set(state["replicas"]) - set(first))
            assert len(replacement) == 1

            export_state_dict(flat, str(root / "v2"), step=8)
            stamp2 = export_signature(str(root / "v2"))
            _wait(lambda: fleet(lambda s: s["canary"]["incumbent"]["stamp"]
                                == stamp2), "promotion", procs=[router])
            _wait(lambda: fleet(loaded("v2")), "v2 everywhere",
                  procs=[router])

            export_state_dict(_poisoned(flat), str(root / "v3"), step=9)
            stamp3 = export_signature(str(root / "v3"))
            _wait(lambda: fleet(lambda s: stamp3 in s["canary"]["rejected"]),
                  "rollback", procs=[router])
            _wait(lambda: fleet(loaded("v2")), "v2 back everywhere",
                  procs=[router])
        assert traffic.failures == []
        assert {1, 8} <= set(traffic.steps)
        router.send_signal(signal.SIGTERM)
        assert router.wait(timeout=60) == 0
    finally:
        if router.poll() is None:
            router.kill()
            router.wait(timeout=10)
        # the router's replicas, should it have left any behind
        log.close()
        for line in router_log.read_text().split("\n"):
            if "spawned serve replica pid=" in line:
                _kill_if_replica(int(line.split("pid=")[1].split()[0]))
    journal = load_journal(events_dir, prefix="router")

    def of(kind, **match):
        return [e for e in journal if e["event"] == kind
                and all(e.get(k) == v for k, v in match.items())]

    assert len(of("replica_lost", replica=victim)) == 1
    assert len(of("replica_registered", replica=replacement[0])) == 1
    grows = of("scale_decision", direction="grow", tag="serve")
    assert [g["delta"] for g in grows] == [2, 1]
    assert all(g["reasons"][0].startswith("below_floor") for g in grows)
    assert len(of("canary_started", stamp=stamp2)) == 1
    assert len(of("canary_started", stamp=stamp3)) == 1  # never retried
    promoted = of("canary_promoted", stamp=stamp2)
    rolled = of("canary_rolled_back", stamp=stamp3)
    assert len(promoted) == 1 and promoted[0]["reasons"][0].startswith(
        "healthy")
    assert len(rolled) == 1 and "drift" in rolled[0]["reasons"][0]


def test_replica_leaves_on_the_routers_drain_directive(tmp_path):
    """A replica managed outside the router registers, heartbeats its
    export versions, and on ``begin_drain`` drains through the SIGTERM
    path: exit 0 and one ``drain_ack`` initiated by the router."""
    root, events_dir = tmp_path / "exports", tmp_path / "events"
    root.mkdir()
    events_dir.mkdir()
    export_state_dict(_weights(np.random.default_rng(0)),
                      str(root / "v1"), step=3)
    from elasticdl_tpu_torch.observability import events

    os.environ[events.EVENTS_DIR_ENV] = str(events_dir)
    try:
        events.configure("router-0")
        servicer = RouterServicer(heartbeat_secs=0.5,
                                  replica_timeout_secs=30.0)
        server = build_server()
        add_router_servicer_to_server(servicer, server)
        rport, sport = find_free_port(), find_free_port()
        server.add_insecure_port("127.0.0.1:%d" % rport)
        server.start()
        replica = subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.serve.main",
             "--device", "cpu", "--model_zoo", ZOO,
             "--model_params", MODEL_PARAMS, "--export_dir", str(root),
             "--port", str(sport), "--router_addr",
             "127.0.0.1:%d" % rport, "--watch_secs", "0.2"],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO,
                               OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            rid = _wait(lambda: (servicer.registry.live_ids() or [None])[0],
                        "registration", procs=[replica])
            entry = _wait(
                lambda: (lambda e: e if e and e.loaded_export else None)(
                    servicer.registry.get(rid)),
                "a heartbeat with the loaded export", procs=[replica])
            assert (entry.loaded_export, entry.available_export) == (
                "v1", "v1")
            assert entry.loaded_stamp == export_signature(str(root / "v1"))
            assert servicer.registry.begin_drain(rid, reason="scale_down")
            assert replica.wait(timeout=60) == 0
            log = replica.stdout.read()
            assert "serve drained (router_drain)" in log, log
        finally:
            if replica.poll() is None:
                replica.kill()
                replica.wait(timeout=10)
            server.stop(0)
        events.flush()
        acks = [e for e in load_journal(events_dir, prefix="router")
                if e["event"] == "drain_ack"]
        assert len(acks) == 1
        assert (acks[0]["replica"], acks[0]["initiator"],
                acks[0]["reason"]) == (rid, "router", "router_drain")
        assert servicer.registry.live_ids() == []
    finally:
        os.environ.pop(events.EVENTS_DIR_ENV, None)
        events._reset_for_tests()


def test_replica_asked_for_cuda_without_a_card_refuses_to_start(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a host without")
    export_state_dict(_weights(np.random.default_rng(0)),
                      str(tmp_path / "v1"), step=1)
    proc = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch.serve.main",
         "--device", "cuda", "--model_zoo", ZOO,
         "--model_params", MODEL_PARAMS, "--export_dir", str(tmp_path),
         "--port", str(find_free_port()), "--router_addr",
         "127.0.0.1:%d" % find_free_port()],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr


def test_router_main_refuses_replica_args_without_an_export_root():
    from elasticdl_tpu_torch.serve import router_main

    args = router_main.parse_router_args(
        ["--port", str(find_free_port()), "--replica_args", "--device cpu"])
    with pytest.raises(SystemExit):
        router_main.RouterRole(args).prepare()
