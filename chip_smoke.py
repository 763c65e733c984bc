#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (elasticdl_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout on a machine with one card and the
CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final ``"ok"`` line):

1. build -- every hand-written kernel, one nvcc per source, all started
   together, from the checkout's sources (K4, ops/csrc/flash_fwd.cu;
   K5 and K6, ops/csrc/flash_bwd.cu), with ptxas's report per entry;
2. kernels -- K4 against its plain PyTorch version on the card at the
   serving and training shape and at five more (fp32, non-causal,
   head_dim 128, ragged S = 1000), each under the tolerance printed
   with it; times of the kernel, the plain version and
   ``scaled_dot_product_attention`` (timed only: the port never calls
   it) with CUDA events, L2 flushed before every launch;
3. backward kernels -- K5 (dq) and K6 (dk, dv) against
   ``flash_attention_bwd_reference`` at the same six shapes, row by row
   (each row's error relative to that row's size), with each kernel
   timed alone beside its own plain version, and the backward of
   ``scaled_dot_product_attention`` (the yardstick for K5 + K6
   together);
4. serve -- zoo-width TransformerLM weights (vocab 32000, 12 layers, 12
   heads, d 768) made with numpy from a seed and written as an export
   bundle; the port's ServeRole on a free port (``--device cuda
   --compute_dtype bfloat16 --max_batch 8``); 8 concurrent one-row
   requests of 1024 tokens over real gRPC through ServeClient. Checks:
   every answer equals ``ServingModel.predict`` on the same row bit for
   bit; the answers agree with the same model forced to plain attention
   within a stated bf16 tolerance; the K4 launch count over the served
   burst is 12 (one per layer) for every batch formed. Then a drain;
5. train -- the zoo TransformerLM at full width and depth trained by
   ``LocalExecutor`` (bf16 compute, fp32 masters, AdamW, minibatch 8,
   S = 1024) over RecordIO token records made with numpy from a seed.
   Checks: every loss is finite; every step launches 12 K4, 12 K5 and
   12 K6; from identical weights the first step's loss, its gradient
   as a whole and the gradient of every attention projection leaf
   agree with the same model on plain attention within the printed
   bf16 tolerances; the loss falls over steps on one repeated batch;
   the exported state serves through ``ServingModel`` with the
   trainer's ``eval_step`` outputs. Then the device time of a step,
   tokens/s, the model-FLOP share of the card's bf16 peak and a
   ``torch.profiler`` breakdown of one step.

The last lines are the kernels JSON line, the card's name and power
limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the JAX package.
"""

import gc
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
    # the served and the trained shape: 8 rows x 12 heads, S 1024, d 64
    ("serve_bf16_causal", 96, 1024, 64, "bfloat16", True),
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
# dq, dk, dv are held row by row: every row r (one query for dq, one
# key for dk and dv) must have ||got_r - ref_r|| <= rtol * (||ref_r|| +
# floor), floor = GRAD_FLOOR * sqrt(head_dim). The rule is relative to
# each row's own size, because under the causal mask a gradient row's
# size falls off along the sequence (|dv_j| ~ 1/sqrt(j)), and a check
# scaled by the tensor's largest entry would pass a wrong late tile. The
# floor keeps rows whose exact gradient is ~0 (dq's first row under the
# causal mask) from dividing by ~0; it is a fifth of a late row's norm
# at the main shape. bf16: the two sides round the same p and ds to
# bf16 and differ in summation order and in the last ulp of some
# products, so a row is off by about one bf16 ulp (2^-8 of the value)
# per entry at most; fp32: summation order only, but dq sums terms
# ds_ij k_j whose ds_ij sum to zero over j, so a row can lose a few
# digits to cancellation. The kernels are deterministic; a right K5/K6
# reads at most 0.0045 (bf16) and 1.1e-4 (fp32) at the main shape on
# an H100, a late tile of dv 10% off reads 0.088. fp32 is also held
# entry by entry to an absolute 1e-4.
GRAD_ROW_RTOL = {"bfloat16": 1e-2, "float32": 1e-3}
GRAD_FLOOR = 1e-2
GRAD_F32_ATOL = 1e-4

# serve-phase tolerance of the kernel model against the same model with
# plain attention, both in bf16: every activation is rounded to bf16 (8
# significant bits) at other points in the two attentions, and the
# differences compound over 12 layers. A wrong kernel moves the mean by
# O(1); rounding moves it by well under 0.02.
SERVE_MEAN_TOL = 0.02
SERVE_MAX_TOL = 0.5

# train phase: the zoo's minibatch and sequence, steps over distinct
# batches, then steps on one repeated batch
TRAIN_BATCH = 8
TRAIN_SEQ = 1024
TRAIN_STEPS = 10
REPEAT_STEPS = 5
# first-step agreement of the kernel model with the same weights on
# plain attention, both bf16 compute with fp32 masters. The loss is a
# mean of bf16 per-sample losses, whose ulp at 8-16 is 0.0625: two ulps.
# The gradients (134M entries, flattened) point the same way to a
# cosine of at least 0.999; a wrong kernel gives a cosine far below.
TRAIN_LOSS_TOL = 0.125
TRAIN_GRAD_COS = 0.999
# and leaf by leaf over the attention projections (query, key, value,
# out_proj of every layer), whose gradients are the ones K5 and K6 feed:
# the worst relative L2 error of one leaf. The flattened cosine above is
# led by lm_head and the embedding, which K5 and K6 never touch. A right
# kernel reads about 0.015 (bf16 rounding at other points in the two
# attentions, over 12 layers); K5 or K6 skipping the diagonal tile of
# late blocks reads 0.071, with the cosine still above 0.9999.
TRAIN_ATTN_LEAF_TOL = 0.03


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


def worst_row_error(got, ref, dim):
    """(max over rows of ||got_r - ref_r|| / (||ref_r|| + floor), the
    median row norm of ref): the row rule of GRAD_ROW_RTOL."""
    err = (got.float() - ref.float()).norm(dim=-1)
    size = ref.float().norm(dim=-1)
    return ((err / (size + GRAD_FLOOR * dim ** 0.5)).max().item(),
            size.median().item())


# per kernel: (matrix products over the kept (q, k) pairs, (seq, dim)
# tensors read or written once, fp32 (bh, seq) statistics read or
# written once). K4: q k^T and p v; reads q, k, v, writes o and lse.
# K5: q k^T, do v^T and ds k; reads q, k, v, do, lse, delta, writes dq.
# K6: q k^T, do v^T, p^T do and ds^T q; reads q, k, v, do, lse, delta,
# writes dk and dv.
KERNEL_WORK = {"fwd": (2, 4, 1), "dq": (3, 5, 2), "dkv": (4, 6, 2)}


def bound(bh, seq, dim, dtype, causal, kernel="fwd"):
    """(bound_ms, bound_by) of one launch of ``kernel``: the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its operations (2 * dim per kept (q, k) pair and
    product; causal keeps seq * (seq + 1) / 2 pairs) over the peak rate
    for its type."""
    products, tensors, stats = KERNEL_WORK[kernel]
    elem = 2 if dtype == "bfloat16" else 4
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    flops = 2.0 * products * bh * dim * pairs
    nbytes = tensors * bh * seq * dim * elem + stats * 4.0 * bh * seq
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


def bwd_kernel_phase(torch, flash):
    """K5 and K6 against the plain backward at every case; each kernel
    timed alone (raw launches of the built library, not counted) beside
    its own plain version, and the backward of
    scaled_dot_product_attention, which computes dq, dk and dv together
    (no PyTorch call computes K5's or K6's part alone)."""
    import torch.nn.functional as F

    from elasticdl_tpu_torch.ops import _build

    lib = _build.load("flash_bwd")
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    stream = torch.cuda.current_stream().cuda_stream
    for name, bh, seq, dim, dtype_name, causal in CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v, do = (
            torch.randn(bh, seq, dim, device="cuda", generator=gen).to(dtype)
            for _ in range(4)
        )
        scale = 1.0 / dim ** 0.5
        o, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
        dq, dk, dv = flash.flash_attention_bwd(q, k, v, o, lse, do,
                                               causal=causal)
        torch.cuda.synchronize()
        refs = flash.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                   causal, scale)
        errs, row_errs, row_norms, oks = {}, {}, {}, []
        rtol = GRAD_ROW_RTOL[dtype_name]
        for grad_name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            err = (got.float() - ref.float()).abs().max().item()
            row_err, row_norm = worst_row_error(got, ref, dim)
            errs[grad_name], row_errs[grad_name] = err, row_err
            row_norms[grad_name] = row_norm
            oks.append(got.shape == q.shape and got.dtype == dtype
                       and bool(torch.isfinite(got.float()).all())
                       and row_err <= rtol
                       and (dtype_name == "bfloat16" or err <= GRAD_F32_ATOL))
        del refs
        delta = (o.float() * do.float()).sum(-1).unsqueeze(1)
        common = (bh, seq, dim, int(dtype == torch.bfloat16), int(causal),
                  scale)
        inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr())

        def launch(fn, *outs):
            if fn(*inputs, *(t.data_ptr() for t in outs), *common, stream):
                raise SystemExit("raw %s launch failed at case %s"
                                 % (fn.__name__, name))

        dq_ms = time_ms(torch, lambda: launch(lib.edl_flash_bwd_dq, dq), flush)
        dkv_ms = time_ms(
            torch, lambda: launch(lib.edl_flash_bwd_dkv, dk, dv), flush)
        args = (q, k, v, o, lse, do, causal, scale)
        dq_plain_ms = time_ms(
            torch, lambda: flash.flash_attention_bwd_dq_reference(*args),
            flush, iters=5)
        dkv_plain_ms = time_ms(
            torch, lambda: flash.flash_attention_bwd_dkv_reference(*args),
            flush, iters=5)
        q4, k4, v4 = (t.view(1, bh, seq, dim).detach().requires_grad_()
                      for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                              scale=scale)
        do4 = do.view(1, bh, seq, dim)
        library_ms = time_ms(torch, lambda: torch.autograd.grad(
            sdpa, (q4, k4, v4), do4, retain_graph=True), flush)
        record = {
            "case": name, "shape": [bh, seq, dim], "dtype": dtype_name,
            "causal": causal,
            "max_abs_err": errs, "worst_row_rel_err": row_errs,
            "tol_row_rel": rtol, "row_floor": GRAD_FLOOR * dim ** 0.5,
            "median_row_norm": row_norms,
            "tol_abs": GRAD_F32_ATOL if dtype_name == "float32" else None,
            "dq_ms": dq_ms, "dkv_ms": dkv_ms, "dq_plain_ms": dq_plain_ms,
            "dkv_plain_ms": dkv_plain_ms, "library_ms_dq_dk_dv": library_ms,
            "dq_bound": bound(bh, seq, dim, dtype_name, causal, "dq"),
            "dkv_bound": bound(bh, seq, dim, dtype_name, causal, "dkv"),
            "ok": all(oks),
        }
        log(json.dumps(record))
        if not record["ok"]:
            raise SystemExit("backward kernel phase failed at case %s" % name)
        results[name] = record
        del q, k, v, do, o, lse, dq, dk, dv, delta, q4, k4, v4, sdpa, do4, args
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
        reset_launches(flash)  # the serve path's count starts here
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        burst_s = time.monotonic() - t0
        launches = flash.LAUNCHES
        if flash.DQ_LAUNCHES or flash.DKV_LAUNCHES:
            raise SystemExit("serving launched backward kernels")
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


def model_train_flops(d, layers, seq, batch, vocab, mlp_ratio=4):
    """Matmul FLOPs of one train step, fwd + bwd = 3x fwd (the formula
    of scripts/bench_transformer_mfu.py:72-81)."""
    tokens = batch * seq
    proj = 2 * tokens * ((4 + 2 * mlp_ratio) * d * d) * layers
    attn = 2 * (2 * batch * seq * seq * d) * layers / 2
    head = 2 * tokens * d * vocab
    return 3 * (proj + attn + head)


def reset_launches(flash):
    flash.LAUNCHES = flash.DQ_LAUNCHES = flash.DKV_LAUNCHES = 0


def read_launches(flash):
    return {"fwd": flash.LAUNCHES, "dq": flash.DQ_LAUNCHES,
            "dkv": flash.DKV_LAUNCHES}


def first_step_agreement(torch, trainer, spec_plain, batch, device):
    """Loss and fp32 master gradients of the first step, from identical
    weights, through the kernel model and the same model on plain
    attention (bf16 compute on both)."""
    from elasticdl_tpu_torch.train.optimizers import sgd
    from elasticdl_tpu_torch.train.step_fns import make_loss_and_grads
    from elasticdl_tpu_torch.train.train_state import create_train_state

    plain = spec_plain.custom_model()
    plain.load_state_dict(trainer.model.state_dict())
    plain = plain.to(device)
    tensors = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    results = []
    for model in (trainer.model, plain):
        state = create_train_state(model, sgd(0.0))
        loss, grads = make_loss_and_grads(
            model, spec_plain.loss, compute_dtype=torch.bfloat16)(
            state, tensors)
        results.append((loss.item(), grads))
        del state
    (loss_k, grads_k), (loss_p, grads_p) = results
    names = sorted(grads_p)
    rel = lambda a, b: ((a.double() - b.double()).norm()
                        / b.double().norm()).item()
    leaf_errs = {n: rel(grads_k[n], grads_p[n]) for n in names
                 if ".attn." in n}
    worst_leaf = max(leaf_errs, key=leaf_errs.get)
    grad_k, grad_p = (torch.cat([g[n].reshape(-1) for n in names]).double()
                      for g in (grads_k, grads_p))
    cosine = (grad_k @ grad_p / (grad_k.norm() * grad_p.norm())).item()
    rel_l2 = ((grad_k - grad_p).norm() / grad_p.norm()).item()
    del plain, results, grads_k, grads_p, grad_k, grad_p
    return {
        "train": "first_step_vs_plain_attention", "loss": loss_k,
        "plain_loss": loss_p, "loss_abs_diff": abs(loss_k - loss_p),
        "tol_loss": TRAIN_LOSS_TOL, "grad_cosine": cosine,
        "tol_grad_cosine": TRAIN_GRAD_COS, "grad_rel_l2": rel_l2,
        "attn_leaves": len(leaf_errs),
        "attn_leaf_worst_rel_l2": leaf_errs[worst_leaf],
        "attn_leaf_worst": worst_leaf,
        "attn_leaf_median_rel_l2": sorted(leaf_errs.values())[
            len(leaf_errs) // 2],
        "tol_attn_leaf_rel_l2": TRAIN_ATTN_LEAF_TOL,
    }


def train_phase(torch, np, flash, workdir, device="cuda", widths=None,
                seq=TRAIN_SEQ, batch=TRAIN_BATCH, steps=TRAIN_STEPS):
    """The train path and its checks; returns what the timing needs."""
    from elasticdl_tpu_torch.data import recordio
    from elasticdl_tpu_torch.data.example import encode_example
    from elasticdl_tpu_torch.models.registry import get_model_spec
    from elasticdl_tpu_torch.serve.model import ServingModel
    from elasticdl_tpu_torch.train.export import export_train_state
    from elasticdl_tpu_torch.train.local_executor import LocalExecutor

    widths = dict(ZOO_WIDTHS if widths is None else widths)
    model_params = ";".join("%s=%d" % kv for kv in sorted(widths.items()))
    layers, vocab = widths["num_layers"], widths["vocab_size"]
    rng = np.random.default_rng(SEED + 2)
    tokens = rng.integers(0, vocab, size=(steps * batch, seq), dtype=np.int32)
    data_dir = os.path.join(workdir, "train_data")
    os.makedirs(data_dir)
    recordio.write_records(os.path.join(data_dir, "part-0.rec"),
                           [encode_example({"tokens": t}) for t in tokens])
    first = {"features": tokens[:batch], "labels": tokens[:batch],
             "_mask": np.ones(batch, np.float32)}

    executor = LocalExecutor(
        ZOO, training_data=data_dir, minibatch_size=batch,
        compute_dtype="bfloat16", seed=SEED, model_params=model_params,
        device=device,
    )
    trainer = executor.trainer
    agreement = first_step_agreement(
        torch, trainer,
        get_model_spec(ZOO, model_params=model_params
                       + ";attention_impl='xla'"),
        first, device)
    log(json.dumps(agreement))
    if (agreement["loss_abs_diff"] > TRAIN_LOSS_TOL
            or not agreement["grad_cosine"] >= TRAIN_GRAD_COS
            or not agreement["attn_leaf_worst_rel_l2"] <= TRAIN_ATTN_LEAF_TOL):
        raise SystemExit("first train step disagrees with plain attention")
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    reset_launches(flash)  # the train path's count starts here
    t0 = time.monotonic()
    losses = executor.train()
    train_s = time.monotonic() - t0
    launches = read_launches(flash)
    record = {
        "train": "local_executor", "steps": len(losses), "seconds": train_s,
        "losses": losses, "launches": launches,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if device == "cuda" else "not measured"),
    }
    log(json.dumps(record))
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise SystemExit("train losses: %s" % losses)
    for name, count in launches.items():
        if count != layers * steps:
            raise SystemExit("%s launches %d over %d steps (want %d a step)"
                             % (name, count, steps, layers))

    state = executor.state
    repeated = []
    for _ in range(REPEAT_STEPS):
        state, loss = trainer.train_step(state, first)
        repeated.append(float(loss))
    log(json.dumps({"train": "repeated_batch", "losses": repeated}))
    if not repeated[-1] < repeated[0]:
        raise SystemExit("loss did not fall on a repeated batch")

    export_dir = os.path.join(workdir, "train_export")
    export_train_state(state, export_dir)
    served = ServingModel(
        get_model_spec(ZOO, model_params=model_params), export_dir,
        max_batch=batch, compute_dtype="bfloat16", device=device,
    ).predict(first["features"], batch)["output"].float().numpy()
    evaluated = trainer.eval_step(state, first)
    diff = np.abs(served - evaluated)
    served_check = {
        "train": "export_served_vs_eval_step", "step": state.step,
        "shape": list(served.shape), "max_abs": float(diff.max()),
        "mean_abs": float(diff.mean()), "bitwise_equal": bool(
            np.array_equal(served, evaluated)),
        "tol_mean": SERVE_MEAN_TOL, "tol_max": SERVE_MAX_TOL,
    }
    log(json.dumps(served_check))
    if (served.shape != (batch, seq, vocab) or not np.isfinite(served).all()
            or served_check["mean_abs"] > SERVE_MEAN_TOL
            or served_check["max_abs"] > SERVE_MAX_TOL):
        raise SystemExit("the exported state serves other outputs")
    return {"trainer": trainer, "state": state, "batch": first,
            "launches": launches, "widths": widths, "seq": seq}


def train_timing(torch, train):
    """Device time of one train step by CUDA events, its host time,
    tokens/s, the model-FLOP share of the bf16 peak, and a
    torch.profiler breakdown of one step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer, state, batch = train["trainer"], train["state"], train["batch"]
    step = lambda: trainer.train_step(state, batch)
    step_ms = device_ms(torch, step)
    t0 = time.monotonic()
    step()
    torch.cuda.synchronize()
    host_ms = (time.monotonic() - t0) * 1e3
    widths, seq = train["widths"], train["seq"]
    rows = int(batch["features"].shape[0])
    flops = model_train_flops(widths["embed_dim"], widths["num_layers"], seq,
                              rows, widths["vocab_size"])
    log(json.dumps({
        "train": "timing", "batch_rows": rows, "seq": seq,
        "step_ms": step_ms, "step_ms_host": host_ms,
        "tokens_per_s": rows * seq / (step_ms / 1e3),
        "model_tflop_per_step": flops / 1e12,
        "mfu_of_bf16_peak": flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"],
    }))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
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
        log(json.dumps({"profile": "train_step", "device_ms": "not measured"}))
        return
    share = lambda tag: sum(ms for key, (ms, _) in kernels.items()
                            if tag in key)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    log(json.dumps({
        "profile": "train_step", "device_busy_ms": busy_ms,
        "idle_share_vs_step_ms": max(0.0, 1.0 - busy_ms / step_ms),
        "k4_ms": share("flash_fwd"), "k5_ms": share("flash_bwd_dq"),
        "k6_ms": share("flash_bwd_dkv"),
        "k4_share": share("flash_fwd") / busy_ms,
        "k5_share": share("flash_bwd_dq") / busy_ms,
        "k6_share": share("flash_bwd_dkv") / busy_ms,
        "top": [[key[:90], ms, n] for key, (ms, n) in top],
    }))


def kernel_entry(name, source, replaces, launches, case, kind):
    """One kernel's record of the kernels line, at the main shape. K5
    and K6 have no library call of their own (library_ms null); the
    backward of scaled_dot_product_attention, which computes what both
    compute, stands once, on K6's record, beside the two kernels' sum."""
    if kind == "fwd":
        err, ms, plain_ms = case["max_abs_err"], case["ms"], case["plain_ms"]
        bound_ms, bound_by = case["bound_ms"], case["bound_by"]
        library_ms = case["library_ms"]
    else:
        grads = ("dq",) if kind == "dq" else ("dk", "dv")
        err = max(case["max_abs_err"][g] for g in grads)
        ms, plain_ms = case["%s_ms" % kind], case["%s_plain_ms" % kind]
        bound_ms, bound_by = case["%s_bound" % kind]
        library_ms = None
    entry = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
    }
    if kind == "dkv":
        entry["ms_k5_k6"] = case["dq_ms"] + case["dkv_ms"]
        entry["library_ms_k5_k6"] = case["library_ms_dq_dk_dv"]
    return entry


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
    bwd_cases = bwd_kernel_phase(torch, flash)

    workdir = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        serve_launches, model, plain, tokens = serve_phase(
            torch, np, flash, workdir)
        serve_timing(torch, model, plain, tokens)
        del model, plain
        gc.collect()
        torch.cuda.empty_cache()
        train = train_phase(torch, np, flash, workdir)
        train_timing(torch, train)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # launches: the train path's count, the slice's main path (the
    # serve path's K4 count is beside it)
    launches = train["launches"]
    main_case = "serve_bf16_causal"  # the served and the trained shape
    fwd = kernel_entry(
        "flash_attention_fwd", "elasticdl_tpu_torch/ops/csrc/flash_fwd.cu",
        "elasticdl_tpu/ops/flash_attention.py:66", launches["fwd"],
        cases[main_case], "fwd")
    fwd["launches_serve"] = serve_launches
    bwd_source = "elasticdl_tpu_torch/ops/csrc/flash_bwd.cu"
    log(json.dumps({"kernels": [
        fwd,
        kernel_entry("flash_attention_bwd_dq", bwd_source,
                     "elasticdl_tpu/ops/flash_attention.py:229",
                     launches["dq"], bwd_cases[main_case], "dq"),
        kernel_entry("flash_attention_bwd_dkv", bwd_source,
                     "elasticdl_tpu/ops/flash_attention.py:293",
                     launches["dkv"], bwd_cases[main_case], "dkv"),
    ]}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
