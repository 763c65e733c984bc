#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (elasticdl_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout on a machine with one card and the
CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final ``"ok"`` line):

1. build -- every hand-written kernel of the serving path, with nvcc
   from the checkout's sources (K4, ops/csrc/flash_fwd.cu);
2. kernels -- K4 against its plain PyTorch version on the card at the
   serving shape and at four more (fp32, non-causal, head_dim 128,
   ragged S = 1000), each under the tolerance printed with it; times of
   the kernel, the plain version and ``scaled_dot_product_attention``
   (timed only: the port never calls it) with CUDA events, L2 flushed
   before every launch;
3. serve -- zoo-width TransformerLM weights (vocab 32000, 12 layers, 12
   heads, d 768) made with numpy from a seed and written as an export
   bundle; the port's ServeRole on a free port (``--device cuda
   --compute_dtype bfloat16 --max_batch 8``); 8 concurrent one-row
   requests of 1024 tokens over real gRPC through ServeClient. Checks:
   every answer equals ``ServingModel.predict`` on the same row bit for
   bit; the answers agree with the same model forced to plain attention
   within a stated bf16 tolerance; the K4 launch count over the served
   burst is 12 (one per layer) for every batch formed. Then a drain.

The last lines are the kernels JSON line, the card's name and power
limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the JAX package.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ZOO = "elasticdl_tpu_torch.models.transformer"
SEED = 0
# the zoo TransformerLM (elasticdl_tpu/models/transformer.py custom_model)
ZOO_WIDTHS = dict(vocab_size=32000, num_layers=12, num_heads=12, embed_dim=768)

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its
# operations over the peak rate for its type
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # fp32 off the tensor cores

# kernel cases: (name, batch*heads, seq, head_dim, dtype, causal)
CASES = (
    ("serve_bf16_causal", 96, 1024, 64, "bfloat16", True),  # the served shape
    ("f32_causal", 96, 1024, 64, "float32", True),
    ("bf16_full", 96, 1024, 64, "bfloat16", False),
    ("bf16_d128_causal", 48, 1024, 128, "bfloat16", True),
    ("bf16_ragged_s1000_causal", 96, 1000, 64, "bfloat16", True),
    ("f32_d128_ragged_s1000_full", 16, 1000, 128, "float32", False),
)
# o tolerance per dtype: bf16 rounds p and o at other points than the
# plain version (one bf16 ulp of O(1) values is 2^-8 = 0.004); fp32
# differs only in summation order. lse is fp32 on both paths.
O_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
LSE_TOL = 1e-3

# serve-phase tolerance of the kernel model against the same model with
# plain attention, both in bf16: every activation is rounded to bf16 (8
# significant bits) at other points in the two attentions, and the
# differences compound over 12 layers. A wrong kernel moves the mean by
# O(1); rounding moves it by well under 0.02.
SERVE_MEAN_TOL = 0.02
SERVE_MAX_TOL = 0.5


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, iters=20, warmup=3):
    """Mean device time of fn() in ms over iters launches, each after
    an L2 flush (a caller's inputs are not L2-resident at this size)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [
        (torch.cuda.Event(enable_timing=True),
         torch.cuda.Event(enable_timing=True))
        for _ in range(iters)
    ]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bound(bh, seq, dim, dtype, causal):
    """(bound_ms, bound_by): bytes = q, k, v, o once each plus lse;
    operations = the two products over the (q, k) pairs this mask
    keeps (causal keeps seq * (seq + 1) / 2 of them)."""
    elem = 2 if dtype == "bfloat16" else 4
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    flops = 4.0 * bh * dim * pairs
    nbytes = 4.0 * bh * seq * dim * elem + 4.0 * bh * seq
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch, flash):
    import torch.nn.functional as F

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for name, bh, seq, dim, dtype_name, causal in CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v = (
            torch.randn(bh, seq, dim, device="cuda", generator=gen).to(dtype)
            for _ in range(3)
        )
        scale = 1.0 / dim ** 0.5
        o, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ro, rlse = flash.flash_attention_fwd_reference(q, k, v, causal, scale)
        err_o = (o.float() - ro.float()).abs().max().item()
        err_lse = (lse - rlse).abs().max().item()
        tol = O_TOL[dtype_name]
        ok = (
            o.shape == q.shape and o.dtype == dtype
            and lse.shape == (bh, 1, seq) and lse.dtype == torch.float32
            and bool(torch.isfinite(o.float()).all())
            and bool(((o.float() - ro.float()).abs()
                      <= tol + tol * ro.float().abs()).all())
            and err_lse <= LSE_TOL
        )
        ms = time_ms(torch, lambda: flash.flash_attention_fwd(
            q, k, v, causal=causal), flush)
        plain_ms = time_ms(torch, lambda: flash.flash_attention_fwd_reference(
            q, k, v, causal, scale), flush)
        q4, k4, v4 = (t.view(1, bh, seq, dim) for t in (q, k, v))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=scale), flush)
        bound_ms, bound_by = bound(bh, seq, dim, dtype_name, causal)
        record = {
            "case": name, "shape": [bh, seq, dim], "dtype": dtype_name,
            "causal": causal, "max_abs_err": err_o,
            "max_abs_err_lse": err_lse, "tol_o": tol, "tol_lse": LSE_TOL,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "ok": ok,
        }
        log(json.dumps(record))
        if not ok:
            raise SystemExit("kernel phase failed at case %s" % name)
        results[name] = record
        del q, k, v, o, lse, ro, rlse
    return results


def zoo_weights(np, rng, vocab_size, num_layers, num_heads, embed_dim):
    """Flax-named fp32 weights: kernels ~ N(0, 1/fan_in), embedding
    ~ N(0, 0.02^2), LayerNorm scale 1 and bias 0."""
    vocab, layers, heads, dim = vocab_size, num_layers, num_heads, embed_dim
    head_dim = dim // heads

    def normal(shape, fan_in):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            fan_in ** -0.5
        )

    flat = {
        "wte/embedding": rng.standard_normal((vocab, dim), dtype=np.float32)
        * np.float32(0.02),
        "ln_f/scale": np.ones(dim, np.float32),
        "ln_f/bias": np.zeros(dim, np.float32),
        "lm_head/kernel": normal((dim, vocab), dim),
    }
    for i in range(layers):
        b = "block_%d/" % i
        for ln in ("ln_attn", "ln_mlp"):
            flat[b + ln + "/scale"] = np.ones(dim, np.float32)
            flat[b + ln + "/bias"] = np.zeros(dim, np.float32)
        for proj in ("query", "key", "value"):
            flat[b + "attn/%s/kernel" % proj] = normal((dim, heads, head_dim), dim)
        flat[b + "attn/out_proj/kernel"] = normal((heads, head_dim, dim), dim)
        flat[b + "mlp_up/kernel"] = normal((dim, 4 * dim), dim)
        flat[b + "mlp_down/kernel"] = normal((4 * dim, dim), 4 * dim)
    return flat


def device_ms(torch, fn, iters=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def serve_phase(torch, np, flash, workdir, device="cuda", widths=None,
                seq=1024):
    """The served burst and its checks; returns (launches, the served
    ServingModel, the plain-attention ServingModel, tokens)."""
    from elasticdl_tpu_torch.common.constants import GRPC
    from elasticdl_tpu_torch.common.grpc_utils import find_free_port
    from elasticdl_tpu_torch.models.registry import get_model_spec
    from elasticdl_tpu_torch.models.transformer import custom_model
    from elasticdl_tpu_torch.serve.client import ServeClient
    from elasticdl_tpu_torch.serve.main import ServeRole, parse_serve_args
    from elasticdl_tpu_torch.serve.model import ServingModel
    from elasticdl_tpu_torch.train.export import export_state_dict

    widths = dict(ZOO_WIDTHS if widths is None else widths)
    model_params = ";".join("%s=%d" % kv for kv in sorted(widths.items()))
    rng = np.random.default_rng(SEED)
    t0 = time.monotonic()
    flat = zoo_weights(np, rng, **widths)
    n_params = sum(a.size for a in flat.values())
    with torch.device("meta"):
        expected = sum(p.numel() for p in custom_model(**widths).parameters())
    if n_params != expected:
        raise SystemExit("weights hold %d parameters, the model %d"
                         % (n_params, expected))
    export_dir = os.path.join(workdir, "export")
    export_state_dict(flat, export_dir, step=1)
    del flat
    log("serve: %d parameters exported in %.1f s" % (
        n_params, time.monotonic() - t0))

    port = find_free_port()
    role = ServeRole(parse_serve_args([
        "--model_zoo", ZOO, "--model_params", model_params,
        "--export_dir", export_dir, "--port", str(port),
        "--device", device, "--compute_dtype", "bfloat16",
        "--max_batch", "8", "--max_delay_ms", "200",
        "--deadline_ms", "600000", "--watch_secs", "3600",
    ])).prepare()
    try:
        engine = role.engine
        if not engine.loaded:
            raise SystemExit("serve role did not load the export")
        vocab = widths["vocab_size"]
        # one answer is a bf16 (1, seq, vocab) tensor: 65.5 MB at the zoo
        # widths, which must fit one gRPC message
        answer_bytes = seq * vocab * 2
        if answer_bytes >= GRPC.MAX_RECEIVE_MESSAGE_LENGTH:
            raise SystemExit("a %d-byte answer exceeds the gRPC cap"
                             % answer_bytes)
        tokens = rng.integers(0, vocab, size=(8, seq), dtype=np.int32)
        answers = [None] * 8
        errors = []

        def one(i):
            try:
                with ServeClient("localhost:%d" % port) as client:
                    answers[i] = client.predict(
                        tokens[i:i + 1], deadline_secs=600
                    )
            except Exception as e:  # recorded and re-raised below
                errors.append(repr(e))

        threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        batches_before = engine.batcher.batches_total
        flash.LAUNCHES = 0  # the main path's count starts here
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        burst_s = time.monotonic() - t0
        launches = flash.LAUNCHES
        batches = engine.batcher.batches_total - batches_before
        if errors or any(a is None for a in answers):
            raise SystemExit("serve requests failed: %s" % errors)
        log(json.dumps({
            "serve": "burst", "requests": 8, "seconds": burst_s,
            "batches": batches, "flash_launches": launches,
        }))
        layers = widths["num_layers"]
        if launches <= 0 or launches != layers * batches:
            raise SystemExit(
                "K4 launches %d over %d batches (want %d per batch)"
                % (launches, batches, layers)
            )

        model = engine.model
        served = []
        for i, (outputs, step, stamp) in enumerate(answers):
            out = outputs["output"]
            if (step != 1 or stamp != model.stamp
                    or tuple(out.shape) != (1, seq, vocab)
                    or out.dtype != torch.bfloat16
                    or not bool(torch.isfinite(out.float()).all())):
                raise SystemExit("bad answer %d: %s %s step %d" % (
                    i, tuple(out.shape), out.dtype, step))
            direct = model.predict(tokens[i:i + 1], 1)["output"]
            if not torch.equal(direct, out):
                raise SystemExit(
                    "answer %d differs from ServingModel.predict" % i)
            served.append(out)
        served = torch.cat(served).float()

        plain = ServingModel(
            get_model_spec(
                ZOO, model_params=model_params + ";attention_impl='xla'"
            ),
            export_dir, max_batch=8, compute_dtype="bfloat16", device=device,
        )
        reference = plain.predict(tokens, 8)["output"].float()
        diff = (served - reference).abs()
        agreement = {
            "serve": "vs_plain_attention", "max_abs": diff.max().item(),
            "mean_abs": diff.mean().item(),
            "ref_max_abs": reference.abs().max().item(),
            "argmax_agree": (served.argmax(-1) == reference.argmax(-1))
            .float().mean().item(),
            "tol_mean": SERVE_MEAN_TOL, "tol_max": SERVE_MAX_TOL,
        }
        log(json.dumps(agreement))
        if (agreement["mean_abs"] > SERVE_MEAN_TOL
                or agreement["max_abs"] > SERVE_MAX_TOL):
            raise SystemExit("served logits disagree with plain attention")
        return launches, model, plain, tokens
    finally:
        role.drain(reason="smoke_done")
        log("serve: drained, served %d, shed %d" % (
            role.engine.batcher.served_total, role.engine.batcher.shed_total))


def serve_timing(torch, model, plain, tokens):
    """Device time of one 8-row forward through the kernel model and the
    plain-attention model, and host time of one predict (pad, copies,
    forward)."""
    tokens_dev = torch.from_numpy(tokens).cuda()
    with torch.inference_mode():
        fwd_ms = device_ms(torch, lambda: model.model(tokens_dev))
        plain_fwd_ms = device_ms(torch, lambda: plain.model(tokens_dev))
    t0 = time.monotonic()
    model.predict(tokens, 8)
    predict_ms = (time.monotonic() - t0) * 1e3
    log(json.dumps({
        "serve": "timing", "batch_rows": int(tokens.shape[0]),
        "seq": int(tokens.shape[1]), "forward_ms": fwd_ms,
        "plain_attention_forward_ms": plain_fwd_ms,
        "predict_ms_host": predict_ms,
    }))
    serve_profile(torch, model, tokens_dev, fwd_ms)


def serve_profile(torch, model, tokens_dev, fwd_ms):
    """Device time by kernel over one 8-row forward (torch.profiler):
    K4's share inside the forward, where its inputs come warm from the
    projections, and the device's idle share against the forward's
    event-timed wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        model.model(tokens_dev)
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        total_us = getattr(evt, "device_time_total", None)
        if total_us is None:
            total_us = evt.cuda_time_total
        kernels[evt.key] = (total_us / 1e3, evt.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    if busy_ms <= 0:
        log(json.dumps({"profile": "forward", "device_ms": "not measured"}))
        return
    flash_ms = sum(ms for key, (ms, _) in kernels.items() if "flash_fwd" in key)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    log(json.dumps({
        "profile": "forward", "device_busy_ms": busy_ms,
        "idle_share_vs_forward_ms": max(0.0, 1.0 - busy_ms / fwd_ms),
        "flash_ms": flash_ms, "flash_share": flash_ms / busy_ms,
        "top": [[key[:90], ms, n] for key, (ms, n) in top],
    }))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke runs on the GPU only", file=sys.stderr)
        return 2
    import numpy as np

    sys.path.insert(0, HERE)
    from elasticdl_tpu_torch.ops import _build
    from elasticdl_tpu_torch.ops import flash_attention as flash

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log("card: %s (%d visible); torch %s, CUDA %s" % (
        smi, torch.cuda.device_count(), torch.__version__, torch.version.cuda))

    build_s = _build.build()
    log(json.dumps({"phase": "build", "seconds": build_s}))
    # ptxas's report per kernel entry: registers, shared memory, spills
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if any(key in line for key in ("Compiling entry", "Used", "spill")):
                log("ptxas %s: %s" % (name, line.strip()))

    cases = kernel_phase(torch, flash)

    workdir = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        launches, model, plain, tokens = serve_phase(torch, np, flash, workdir)
        serve_timing(torch, model, plain, tokens)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    main_case = cases["serve_bf16_causal"]
    log(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "elasticdl_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "elasticdl_tpu/ops/flash_attention.py:66",
        "launches": launches,
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
