#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (elasticdl_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout on a machine with one card and the
CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final ``"ok"`` line):

1. build -- every hand-written kernel, one nvcc per source, all started
   together, from the checkout's sources (K4, ops/csrc/flash_fwd.cu;
   K5 and K6, ops/csrc/flash_bwd.cu; K1-K3, ops/csrc/embedding_tier.cu),
   with ptxas's report per entry; beside them a copy of K1-K3's source
   under build/ with programmatic dependent launch off (the serial
   chain of phase 4);
2. kernels -- K4 against its plain PyTorch version on the card at the
   serving and training shape and at five more (fp32, non-causal,
   head_dim 128, ragged S = 1000), each under the tolerance printed
   with it; times of the kernel, the plain version and
   ``scaled_dot_product_attention`` (timed only: the port never calls
   it) with CUDA events, L2 flushed before every launch;
3. backward kernels -- K5 (dq) and K6 (dk, dv) against
   ``flash_attention_bwd_reference`` at the same six shapes, row by row
   (each row's error relative to that row's size), raw launches on the
   same inputs bit-equal to the wrapper's, each kernel timed alone
   beside its own plain version, the wrapper (delta and both kernels)
   and the backward of ``scaled_dot_product_attention`` (the yardstick
   for K5 + K6 together);
4. tier kernels -- K1 (gather-merge), K2 (insert rows: a staging
   chunk into the weights, the slot buffers and the step counts in one
   launch) and K3 (scatter-apply), ops/csrc/embedding_tier.cu, against
   their plain versions at deepfm's deployment shapes for both tables
   (d 8 and 1): K1 and K2 bit for bit (K2 on every buffer), K3 for
   each of sgd, momentum, nesterov, adagrad and adam within the
   tolerance printed with it on every row but the scratch row, which
   the kernel leaves alone; each timed with CUDA events (L2 flushed)
   beside its plain version, its bound and a library yardstick (K1
   index_select + torch.where, K2 index_copy_ + index_fill_ x 3, K3
   none), K3 also on all hits beside the real mix; K1 also by the
   profiler; then the staging chunk's chain (K1 victims -> K2 insert ->
   K1 combined, the last two programmatic dependent launches) with
   every insert reusing a victim's slot, 200 runs at each width, each
   bit-equal to the plain versions applied in order; and the chain's
   device span with programmatic dependent launch against the serial
   copy's, in turns, by CUDA events and by the profiler;
5. serve -- zoo-width TransformerLM weights (vocab 32000, 12 layers, 12
   heads, d 768) made with numpy from a seed and written as an export
   bundle; the port's ServeRole on a free port (``--device cuda
   --compute_dtype bfloat16 --max_batch 8``); 8 concurrent one-row
   requests of 1024 tokens over real gRPC through ServeClient. Checks:
   every answer equals ``ServingModel.predict`` on the same row bit for
   bit; the answers agree with the same model forced to plain attention
   within a stated bf16 tolerance; the K4 launch count over the served
   burst is 12 (one per layer) for every batch formed. Then a drain;
6. train -- the zoo TransformerLM at full width and depth trained by
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
   ``torch.profiler`` breakdown of one step;
7. sparse train -- DeepFM through the port's ``SparseTrainer`` with
   the device tier at bench.py's deployment configuration (39 fields,
   batch 512, id capacity 8192, Zipf(1.2) ids, the in-process store
   ``LocalPSClient`` builds -- the native C++ store, ps/embedding_store.py
   -- and the tier, both adam lr 0.001, tier capacity 65536). Checks:
   the store is a ``NativeEmbeddingStore`` (its class and library
   printed); a tier that never promotes is bit-exact with the tier off;
   the card agrees with the CPU over the first steps on the same store
   class (loss, touched store rows, tier rows); 110 steps with finite
   losses, K1-K3 launches per step as the path requires and a warm hit
   rate above 0; the loss falls on a repeated batch; a 4096-row tier
   evicts and, after ``close()``, holds every resident row bit-equal to
   the store's. Then steps/s, examples/s, the host stage split of each
   store (medians over 10 fresh steps, the native trainer and a numpy
   one that replayed the same steps, in turns) and a profiled step
   (device busy, idle share, K1-K3 share).

The last lines are the kernels JSON line, the card's name and power
limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --mutations`` plants each fault of
``K4_MUTATIONS``, ``BWD_MUTATIONS`` and ``TIER_MUTATIONS`` in its own
copy of the port under build/ and requires the kernel phase to fail
there, then times K4's schedules (``K4_SCHEDULES``) and K3's handling
of misses (``K3_VARIANTS``) in turns.
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


def roofline(nbytes, flops, dtype="float32"):
    """(bound_ms, bound_by): the larger of ``nbytes`` over the memory
    rate and ``flops`` over the peak rate for ``dtype``."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(bh, seq, dim, dtype, causal, kernel="fwd"):
    """(bound_ms, bound_by) of one launch of ``kernel``: its bytes (each
    input read once, each output written once) and its operations (2 *
    dim per kept (q, k) pair and product; causal keeps seq * (seq + 1) /
    2 pairs) on the roofline."""
    products, tensors, stats = KERNEL_WORK[kernel]
    elem = 2 if dtype == "bfloat16" else 4
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    flops = 2.0 * products * bh * dim * pairs
    nbytes = tensors * bh * seq * dim * elem + stats * 4.0 * bh * seq
    return roofline(nbytes, flops, dtype)


def raw_launch(torch, fn, *args):
    """A no-argument launcher of the C function ``fn`` of a built kernel
    library on the current stream: no wrapper checks, no launch count."""
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if fn(*args, stream):
            raise SystemExit("raw %s launch failed" % fn.__name__)

    return launch


def kernel_phase(torch, flash, cases=CASES, baselines=True):
    """K4 against its plain version at every case, and a raw launch of
    the built library's ``edl_flash_fwd`` on the same inputs bit-equal
    to the wrapper's. K4 is timed by that raw call (no wrapper, not
    counted) with the wrapper's time beside it; ``baselines`` adds the
    plain version's and scaled_dot_product_attention's times."""
    import torch.nn.functional as F

    from elasticdl_tpu_torch.ops import _build

    lib = _build.load("flash_fwd")
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for name, bh, seq, dim, dtype_name, causal in cases:
        dtype = getattr(torch, dtype_name)
        q, k, v = (
            torch.randn(bh, seq, dim, device="cuda", generator=gen).to(dtype)
            for _ in range(3)
        )
        scale = 1.0 / dim ** 0.5
        o, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
        o_raw, lse_raw = torch.empty_like(o), torch.empty_like(lse)
        raw = raw_launch(torch, lib.edl_flash_fwd, q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), o_raw.data_ptr(), lse_raw.data_ptr(),
                         bh, seq, dim, int(dtype == torch.bfloat16),
                         int(causal), scale)
        raw()
        torch.cuda.synchronize()
        bit_equal = torch.equal(o, o_raw) and torch.equal(lse, lse_raw)
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
            and err_lse <= LSE_TOL and bit_equal
        )
        record = {
            "case": name, "shape": [bh, seq, dim], "dtype": dtype_name,
            "causal": causal, "max_abs_err": err_o,
            "max_abs_err_lse": err_lse, "tol_o": tol, "tol_lse": LSE_TOL,
            "launches_bit_equal": bit_equal,
        }
        if not ok:
            log(json.dumps(dict(record, ok=False)))
            raise SystemExit("kernel phase failed at case %s" % name)
        record["ms"] = time_ms(torch, raw, flush)
        record["wrapper_ms"] = time_ms(torch, lambda: flash.flash_attention_fwd(
            q, k, v, causal=causal), flush)
        # host time of one raw call (ctypes, the bf16 path's three tensor
        # map encodings, the launch), enqueued back to back
        t0 = time.perf_counter()
        for _ in range(100):
            raw()
        record["host_us_per_raw_call"] = (time.perf_counter() - t0) * 1e4
        torch.cuda.synchronize()
        if baselines:
            record["plain_ms"] = time_ms(
                torch, lambda: flash.flash_attention_fwd_reference(
                    q, k, v, causal, scale), flush)
            q4, k4, v4 = (t.view(1, bh, seq, dim) for t in (q, k, v))
            record["library_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal, scale=scale), flush)
            del q4, k4, v4
        record["bound_ms"], record["bound_by"] = bound(
            bh, seq, dim, dtype_name, causal)
        record["ok"] = ok
        log(json.dumps(record))
        results[name] = record
        del q, k, v, o, lse, o_raw, lse_raw, ro, rlse
    return results


def bwd_kernel_phase(torch, flash, timing=True):
    """K5 and K6 against the plain backward at every case, and raw
    launches of the built library's C functions on the same inputs
    bit-equal to the wrapper's; with ``timing``, each kernel timed
    alone by those raw launches (not counted) beside the wrapper
    ``flash_attention_bwd`` (checks, delta, K5 and K6: the only wrapper
    either kernel has), its own plain version, and the backward of
    scaled_dot_product_attention, which computes dq, dk and dv together
    (no PyTorch call computes K5's or K6's part alone)."""
    import torch.nn.functional as F

    from elasticdl_tpu_torch.ops import _build

    lib = _build.load("flash_bwd")
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
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
        raw_out = [torch.empty_like(q) for _ in range(3)]
        raw_dq = raw_launch(torch, lib.edl_flash_bwd_dq, *inputs,
                            raw_out[0].data_ptr(), *common)
        raw_dkv = raw_launch(torch, lib.edl_flash_bwd_dkv, *inputs,
                             raw_out[1].data_ptr(), raw_out[2].data_ptr(),
                             *common)
        raw_dq()
        raw_dkv()
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(a, b)
                        for a, b in zip(raw_out, (dq, dk, dv)))
        oks.append(bit_equal)
        record = {
            "case": name, "shape": [bh, seq, dim], "dtype": dtype_name,
            "causal": causal,
            "max_abs_err": errs, "worst_row_rel_err": row_errs,
            "tol_row_rel": rtol, "row_floor": GRAD_FLOOR * dim ** 0.5,
            "median_row_norm": row_norms,
            "tol_abs": GRAD_F32_ATOL if dtype_name == "float32" else None,
            "launches_bit_equal": bit_equal,
            "dq_bound": bound(bh, seq, dim, dtype_name, causal, "dq"),
            "dkv_bound": bound(bh, seq, dim, dtype_name, causal, "dkv"),
            "ok": all(oks),
        }
        if not record["ok"]:
            log(json.dumps(record))
            raise SystemExit("backward kernel phase failed at case %s" % name)
        if not timing:
            log(json.dumps(record))
            results[name] = record
            del q, k, v, do, o, lse, dq, dk, dv, delta, raw_out
            continue
        record["dq_ms"] = time_ms(torch, raw_dq, flush)
        record["dkv_ms"] = time_ms(torch, raw_dkv, flush)
        record["wrapper_ms_dq_dk_dv"] = time_ms(
            torch, lambda: flash.flash_attention_bwd(q, k, v, o, lse, do,
                                                     causal=causal), flush)
        args = (q, k, v, o, lse, do, causal, scale)
        record["dq_plain_ms"] = time_ms(
            torch, lambda: flash.flash_attention_bwd_dq_reference(*args),
            flush, iters=5)
        record["dkv_plain_ms"] = time_ms(
            torch, lambda: flash.flash_attention_bwd_dkv_reference(*args),
            flush, iters=5)
        q4, k4, v4 = (t.view(1, bh, seq, dim).detach().requires_grad_()
                      for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                              scale=scale)
        do4 = do.view(1, bh, seq, dim)
        record["library_ms_dq_dk_dv"] = time_ms(
            torch, lambda: torch.autograd.grad(
                sdpa, (q4, k4, v4), do4, retain_graph=True), flush)
        log(json.dumps(record))
        results[name] = record
        del q, k, v, do, o, lse, dq, dk, dv, delta, raw_out, q4, k4, v4
        del sdpa, do4, args
    return results


# device-tier kernels K1-K3 at deepfm's deployment shapes (bench.py:65-78,
# 106-129): tier capacity 65536 + 1 scratch row; the combined buffer is
# the id capacity min(512 * 39, 8192) = 8192 rows, of which a Zipf(1.2)
# batch fills about 5100 unique ids; a staging chunk is launched at its
# real length, which the main run's resident rows over its insert chunks
# put at about 540 (118k rows in 218 chunks): 512 promotions and 512
# victims here
TIER_ROWS = 65536 + 1
TIER_CAPACITY_IDS = 8192
TIER_UNIQUE = 5100
TIER_HIT_SHARE = 0.6
TIER_STAGED = 512
TIER_DIMS = (("deepfm_emb", 8), ("deepfm_linear", 1))
TIER_OPTS = ("sgd", "momentum", "nesterov", "adagrad", "adam")
# K3 against its plain version on every row but the scratch row: the
# kernel rounds each operation once in the plain version's order (no FMA
# contraction), so only adam's powf(beta, t) may differ from torch's pow
# by an fp32 ulp; a few ulps on the row: relative 2e-6, absolute 1e-7
K3_RTOL, K3_ATOL = 2e-6, 1e-7
# fp32 operations per element of K3, per optimizer (adam adds two powf
# a row): far under the bytes, so the bound is the memory's
K3_FLOPS = {"sgd": 2, "momentum": 4, "nesterov": 6, "adagrad": 6, "adam": 16}


def tier_inputs(torch, np, rng, dim, opt_type, device="cuda"):
    """A random tier state of TIER_ROWS rows and the slot arrays of one
    step: the combined buffer's slots (unique hits, misses -1, padding
    -1), a staging chunk's insert and evict slots (unique) and the
    inserted rows."""
    from elasticdl_tpu_torch.ops import embedding_tier as tier

    scratch = TIER_ROWS - 1
    state = tier.init_table_state(TIER_ROWS, dim, opt_type, device=device)
    state["rows"].copy_(torch.from_numpy(
        rng.standard_normal((TIER_ROWS, dim), dtype=np.float32) * 0.01))
    for key in state:
        if key.startswith("slot"):
            state[key].copy_(torch.from_numpy(
                rng.random((TIER_ROWS, dim), dtype=np.float32) * 1e-4))
    state["steps"].copy_(torch.from_numpy(
        rng.integers(0, 100, TIER_ROWS).astype(np.int32)))
    perm = rng.permutation(scratch).astype(np.int32)
    slots = np.full(TIER_CAPACITY_IDS, -1, np.int32)
    hits = int(TIER_UNIQUE * TIER_HIT_SHARE)
    slots[:TIER_UNIQUE][rng.permutation(TIER_UNIQUE)[:hits]] = perm[:hits]
    arrays = {
        "slots": slots, "ins": perm[hits:hits + TIER_STAGED],
        "evict": perm[hits + TIER_STAGED:hits + 2 * TIER_STAGED],
        "miss": rng.standard_normal((TIER_CAPACITY_IDS, dim),
                                    dtype=np.float32),
        "ins_rows": rng.standard_normal((TIER_STAGED, dim),
                                        dtype=np.float32),
        "grads": rng.standard_normal((TIER_CAPACITY_IDS, dim),
                                     dtype=np.float32) * 1e-3,
    }
    return state, {k: torch.from_numpy(v).to(device)
                   for k, v in arrays.items()}


# deepfm's tier optimizer: lr, momentum, beta1, beta2, eps
K3_HYPER = (0.001, 0.9, 0.9, 0.999, 1e-8)


def k3_raw(torch, np, lib, state, slots, grads, opt_type):
    """A raw launcher of K3 (``raw_launch``) on ``state`` with the
    wrapper's arguments at K3_HYPER (1 - beta rounded once to fp32)."""
    from elasticdl_tpu_torch.ops import embedding_tier as tier

    lr, momentum, beta1, beta2, eps = K3_HYPER
    slot_ptrs = [state[key].data_ptr() for key in sorted(state)
                 if key.startswith("slot")]
    slot_ptrs += [None] * (2 - len(slot_ptrs))
    return raw_launch(
        torch, lib.edl_tier_scatter_apply, grads.data_ptr(),
        slots.data_ptr(), state["rows"].data_ptr(), *slot_ptrs,
        state["steps"].data_ptr(), int(slots.shape[0]),
        state["rows"].shape[1], state["rows"].shape[0],
        tier._OPT_CODES[opt_type], lr, momentum, beta1,
        float(np.float32(1.0 - beta1)), beta2,
        float(np.float32(1.0 - beta2)), eps)


def k3_bound(n, hits, dim, opt_type):
    """(bound_ms, bound_by) of one K3 launch: the slots read, and for
    each hit its gradient read, its weights and slot buffers read and
    written and its step count read and written (a miss needs nothing)."""
    from elasticdl_tpu_torch.ops import embedding_tier as tier

    buffers = 1 + tier.TIER_OPT_SLOTS[opt_type]
    return roofline(4 * n + hits * (4 * dim + 2 * 4 * dim * buffers + 8),
                    K3_FLOPS[opt_type] * hits * dim)


def kernel_device_ms(torch, fn, prefix, flush, iters=20):
    """Mean device time in ms of the kernels whose profiler name starts
    with ``prefix``, over ``iters`` calls of fn() (each after an L2
    flush), read from torch.profiler: the kernel's own run, without the
    launch and event overhead that time_ms counts (a few microseconds,
    as much as a small kernel's run). None when the profiler sees no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.key.startswith(prefix):
            total_us += getattr(evt, "device_time_total", None) or \
                evt.cuda_time_total
            count += evt.count
    return total_us / 1e3 / count if count and total_us > 0 else None


def k3_hit_mix_ms(torch, np, lib, flush, state, t):
    """K3 (adam) by raw launch on the real mix of ``t["slots"]`` (hits
    and -1) and on as many slots all hits: what the misses cost, by
    CUDA events (``_ms``) and by the profiler (``_device_ms``)."""
    n = int(t["slots"].shape[0])
    all_hits = torch.from_numpy(np.random.default_rng(SEED + 4).permutation(
        TIER_ROWS - 1)[:n].astype(np.int32)).to(t["slots"].device)
    out = {}
    for key, slots in (("real_mix", t["slots"]), ("all_hits", all_hits)):
        work = {k: v.clone() for k, v in state.items()}
        raw = k3_raw(torch, np, lib, work, slots, t["grads"], "adam")
        out[key + "_ms"] = time_ms(torch, raw, flush)
        out[key + "_device_ms"] = kernel_device_ms(
            torch, raw, TIER_PROFILE_PREFIX["k3"], flush)
        out[key + "_hits"] = int((slots >= 0).sum())
    return out


def k3_hit_mix_timing(torch, np):
    """``k3_hit_mix_ms`` at deepfm_emb's shape, printed as one line (the
    --mutations run times it on each of K3_VARIANTS)."""
    from elasticdl_tpu_torch.ops import _build

    lib = _build.load("embedding_tier")
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    state, t = tier_inputs(torch, np, np.random.default_rng(SEED + 3), 8,
                           "adam")
    log(json.dumps({"k3_hit_mix": k3_hit_mix_ms(torch, np, lib, flush,
                                                state, t)}))


def tier_kernel_phase(torch, np, tier, timing=True):
    """K1, K2 and K3 against their plain versions on the card at
    deepfm's shapes, for both tables (d 8 and 1) and, for K3, every
    optimizer: K1 and K2 bit for bit (K2 on every buffer of an adam
    state: weights, m, v, step counts), K3 within K3_RTOL/K3_ATOL on
    every row but scratch. With ``timing``, each kernel is timed alone
    (CUDA events, L2 flushed before each launch) by a raw call of the
    built library (no wrapper, not counted), with the wrapper's time
    beside it, its plain version, its bound from this run's inputs and
    a library yardstick: K1 ``index_select`` + ``torch.where`` (two
    calls), K2 ``index_copy_`` + three ``index_fill_`` (four calls), K3
    none; K3 (adam, d 8) also on as many slots all hits; K1 also by the
    profiler (``device_ms``). Then ``chain_check`` at both widths.
    Returns {kernel: {table: record}} and {"chain": {table: record}}."""
    from elasticdl_tpu_torch.ops import _build

    lib = _build.load("embedding_tier")
    flush = (torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
             if timing else None)

    def timed(record, **fns):
        if timing:
            record.update({key: time_ms(torch, fn, flush)
                           for key, fn in fns.items()})

    rng = np.random.default_rng(SEED + 3)
    results = {"gather": {}, "insert_rows": {}, "scatter_apply": {}}
    scratch = TIER_ROWS - 1
    for table, dim in TIER_DIMS:
        state, t = tier_inputs(torch, np, rng, dim, "adam")
        rows = state["rows"]
        slots, miss = t["slots"], t["miss"]
        hits = int((slots >= 0).sum())
        # K1: the combined buffer and the eviction read
        got = tier.gather_merge(rows, slots, miss)
        got_ev = tier.gather_merge(rows, t["evict"])
        torch.cuda.synchronize()
        want = tier.gather_merge_reference(rows, slots, miss)
        want_ev = tier.gather_merge_reference(rows, t["evict"])
        exact = torch.equal(got, want) and torch.equal(got_ev, want_ev)
        err = max((got - want).abs().max().item(),
                  (got_ev - want_ev).abs().max().item())
        long_slots = slots.long()
        hit_mask = (slots >= 0)[:, None]
        safe = torch.where(slots >= 0, long_slots, 0)
        n = slots.shape[0]
        out = torch.empty_like(got)
        raw = raw_launch(torch, lib.edl_tier_gather, rows.data_ptr(),
                         slots.data_ptr(), miss.data_ptr(), out.data_ptr(),
                         n, dim, TIER_ROWS, 0)
        raw()
        torch.cuda.synchronize()
        exact = exact and torch.equal(out, got)
        record = {
            "table": table, "shape": [n, dim], "table_rows": TIER_ROWS,
            "hits": hits, "bit_exact": exact, "max_abs_err": err,
            "library_calls": "index_select + torch.where (two calls)",
        }
        timed(record, ms=raw,
              wrapper_ms=lambda: tier.gather_merge(rows, slots, miss),
              plain_ms=lambda: tier.gather_merge_reference(rows, slots,
                                                           miss),
              library_ms=lambda: torch.where(
                  hit_mask, rows.index_select(0, safe), miss))
        if timing:
            record["device_ms"] = kernel_device_ms(
                torch, raw, TIER_PROFILE_PREFIX["k1"], flush)
        # slots, the rows read (a hit from the table, a miss from the
        # miss buffer) and the rows written
        record["bound_ms"], record["bound_by"] = roofline(
            4 * n + 2 * 4 * n * dim, 0)
        log(json.dumps({"tier_kernel": "K1 gather_merge", **record}))
        results["gather"][table] = record
        if not exact:
            raise SystemExit("K1 disagrees with its plain version (%s)"
                             % table)

        # K2: a staging chunk inserted into the whole adam state (rows,
        # m, v, steps) by the wrapper and by a raw launch, and the
        # one-buffer set_rows (rows, then zeros); every buffer compared
        # whole (the chunk holds no scratch slot)
        ins, ins_rows = t["ins"], t["ins_rows"]
        n = int(ins.shape[0])
        got = {k: v.clone() for k, v in state.items()}
        want = {k: v.clone() for k, v in state.items()}
        work = {k: v.clone() for k, v in state.items()}
        tier.insert_rows(got, ins, ins_rows)
        tier.insert_rows_reference(want, ins, ins_rows)
        raw = raw_launch(torch, lib.edl_tier_insert_rows,
                         work["rows"].data_ptr(), work["slot0"].data_ptr(),
                         work["slot1"].data_ptr(), work["steps"].data_ptr(),
                         ins.data_ptr(), ins_rows.data_ptr(), n, dim,
                         TIER_ROWS, 0)
        raw()
        torch.cuda.synchronize()
        exact = all(torch.equal(got[k], want[k]) and torch.equal(work[k],
                                                                 want[k])
                    for k in want)
        err = max(float((got[k] - want[k]).abs().max()) for k in want)
        for values in (ins_rows, None):
            one, plain = rows.clone(), rows.clone()
            tier.set_rows(one, ins, values)
            tier.set_rows_reference(plain, ins, values)
            torch.cuda.synchronize()
            exact = exact and torch.equal(one, plain)
            err = max(err, (one - plain).abs().max().item())
        ins_long = ins.long()

        def library():
            work["rows"].index_copy_(0, ins_long, ins_rows)
            work["slot0"].index_fill_(0, ins_long, 0.0)
            work["slot1"].index_fill_(0, ins_long, 0.0)
            work["steps"].index_fill_(0, ins_long, 0)

        record = {
            "table": table, "shape": [n, dim],
            "buffers": sorted(state), "bit_exact": exact,
            "max_abs_err": err,
            "library_calls": "index_copy_ + index_fill_ x 3 (four calls)",
        }
        timed(record, ms=raw,
              wrapper_ms=lambda: tier.insert_rows(work, ins, ins_rows),
              plain_ms=lambda: tier.insert_rows_reference(work, ins,
                                                          ins_rows),
              library_ms=library)
        # slots and rows read; the weights, both slot buffers and the
        # step counts written
        record["bound_ms"], record["bound_by"] = roofline(
            4 * n + 4 * n * dim + 3 * 4 * n * dim + 4 * n, 0)
        log(json.dumps({"tier_kernel": "K2 insert_rows", **record}))
        results["insert_rows"][table] = record
        if not exact:
            raise SystemExit("K2 disagrees with its plain version (%s)"
                             % table)
        del got, want, work

        # K3: every optimizer on the combined buffer's gradients
        per_opt = {}
        for opt_type in TIER_OPTS:
            base, t = tier_inputs(torch, np, rng, dim, opt_type)
            slots, grads = t["slots"], t["grads"]
            got = {k: v.clone() for k, v in base.items()}
            want = {k: v.clone() for k, v in base.items()}
            args = (opt_type,) + K3_HYPER
            tier.scatter_apply(got, slots, grads, *args)
            tier.scatter_apply_reference(want, slots, grads, *args)
            torch.cuda.synchronize()
            err, ok = 0.0, torch.equal(got["steps"][:scratch],
                                        want["steps"][:scratch])
            for key in got:
                if key == "steps":
                    continue
                a, b = got[key][:scratch], want[key][:scratch]
                err = max(err, (a - b).abs().max().item())
                ok = ok and bool(((a - b).abs()
                                  <= K3_ATOL + K3_RTOL * b.abs()).all())
            work = {k: v.clone() for k, v in base.items()}
            n = slots.shape[0]
            hits = int((slots >= 0).sum())
            record = {
                "table": table, "opt": opt_type, "shape": [n, dim],
                "hits": hits, "max_abs_err": err, "rtol": K3_RTOL,
                "atol": K3_ATOL, "ok": ok, "library_ms": None,
            }
            timed(record, ms=k3_raw(torch, np, lib, work, slots, grads,
                                    opt_type),
                  wrapper_ms=lambda: tier.scatter_apply(work, slots, grads,
                                                        *args),
                  plain_ms=lambda: tier.scatter_apply_reference(
                      work, slots, grads, *args))
            if timing and (table, opt_type) == ("deepfm_emb", "adam"):
                record.update(k3_hit_mix_ms(torch, np, lib, flush, base, t))
            record["bound_ms"], record["bound_by"] = k3_bound(
                n, hits, dim, opt_type)
            log(json.dumps({"tier_kernel": "K3 scatter_apply", **record}))
            per_opt[opt_type] = record
            if not ok:
                raise SystemExit("K3 (%s, %s) disagrees with its plain "
                                 "version" % (opt_type, table))
            del base, got, want, work
        results["scatter_apply"][table] = per_opt
        del state
    results["chain"] = {table: chain_check(torch, np, tier, dim)
                        for table, dim in TIER_DIMS}
    return results


# the staging chunk's chain on the card, K1 (victims' rows) -> K2 (the
# insert) -> K1 (the combined buffer), the second and third launched as
# programmatic dependents of the one before. Each run is queued behind a
# sleeping kernel (torch.cuda._sleep, about 0.5 ms at the card's clock),
# so that its launches meet on the card as they would behind a busy
# stream, not one by one behind the host.
CHAIN_REPS = 200
CHAIN_SLEEP_CYCLES = 1_000_000
CHAIN_TIMING_REPS = 100
# the serial chain: the same source with the launch attribute off, built
# in a copy under build/ and timed against the checkout's, in turns
K1_CHAIN_VARIANTS = {
    "pdl": (),
    "serial": (("  attr[0].val.programmaticStreamSerializationAllowed = "
                "pdl ? 1 : 0;\n",
                "  attr[0].val.programmaticStreamSerializationAllowed = 0;"
                "\n"),),
}


def chain_inputs(torch, np, rng, dim, device="cuda"):
    """tier_inputs' adam state and arrays for one staging chunk whose
    inserts reuse every victim's slot (in another order) and whose
    promoted rows are hits of the combined buffer: the case where the
    chain's order decides every value."""
    state, t = tier_inputs(torch, np, rng, dim, "adam", device)
    evict = t["evict"].cpu().numpy()
    slots = t["slots"].cpu().numpy()
    ins = evict[rng.permutation(evict.size)]
    slots[TIER_UNIQUE:TIER_UNIQUE + ins.size] = ins
    t["ins"] = torch.from_numpy(ins).to(device)
    t["slots"] = torch.from_numpy(slots).to(device)
    return state, t


def chain_check(torch, np, tier, dim, reps=CHAIN_REPS, device="cuda"):
    """``fused_insert_gather`` on chain_inputs, ``reps`` times from the
    same state, each run queued behind a sleep: the victims' rows, the
    combined buffer and every buffer of the state must equal the plain
    versions applied in order (gather_merge_reference,
    insert_rows_reference, gather_merge_reference), bit for bit, in
    every run. Logs how many runs disagreed, then raises if any did."""
    rng = np.random.default_rng(SEED + 5)
    state, t = chain_inputs(torch, np, rng, dim, device)
    want = {k: v.clone() for k, v in state.items()}
    want_ev = tier.gather_merge_reference(want["rows"], t["evict"])
    tier.insert_rows_reference(want, t["ins"], t["ins_rows"])
    want_comb = tier.gather_merge_reference(want["rows"], t["slots"],
                                            t["miss"])
    work = {k: v.clone() for k, v in state.items()}
    bad = []
    for rep in range(reps):
        torch.cuda._sleep(CHAIN_SLEEP_CYCLES)
        for key in work:
            work[key].copy_(state[key])
        _, comb, ev = tier.fused_insert_gather(
            work, t["ins"], t["ins_rows"], t["evict"], t["slots"], t["miss"])
        wrong = [name for name, got, ref in (
            ("evicted", ev, want_ev), ("combined", comb, want_comb),
            *((k, work[k], want[k]) for k in want))
            if not torch.equal(got, ref)]
        if wrong:
            bad.append([rep, wrong])
    record = {"tier_chain": "K1 -> K2 -> K1, inserts into the victims' "
              "slots", "dim": dim, "reps": reps, "mismatches": len(bad),
              "first_mismatches": bad[:5], "staged": TIER_STAGED,
              "combined": int(t["slots"].shape[0])}
    log(json.dumps(record))
    if bad:
        raise SystemExit("the chain disagrees with the plain versions in "
                         "%d of %d runs (d %d)" % (len(bad), reps, dim))
    return record


def chain_launcher(torch, lib, state, t):
    """One chunk chain by raw calls of ``lib``'s C functions (no
    wrapper, not counted): K1 on the victims (plain launch), K2 and K1
    on the combined buffer as programmatic dependents (pdl 1; a library
    built with the attribute off ignores it)."""
    rows = state["rows"]
    n_ev, dim = int(t["evict"].shape[0]), rows.shape[1]
    out_ev = torch.empty((n_ev, dim), device=rows.device)
    out = torch.empty((int(t["slots"].shape[0]), dim), device=rows.device)
    calls = (
        (lib.edl_tier_gather, rows.data_ptr(), t["evict"].data_ptr(), None,
         out_ev.data_ptr(), n_ev, dim, rows.shape[0], 0),
        (lib.edl_tier_insert_rows, rows.data_ptr(), state["slot0"].data_ptr(),
         state["slot1"].data_ptr(), state["steps"].data_ptr(),
         t["ins"].data_ptr(), t["ins_rows"].data_ptr(),
         int(t["ins"].shape[0]), dim, rows.shape[0], 1),
        (lib.edl_tier_gather, rows.data_ptr(), t["slots"].data_ptr(),
         t["miss"].data_ptr(), out.data_ptr(), int(t["slots"].shape[0]),
         dim, rows.shape[0], 1),
    )
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        for fn, *args in calls:
            if fn(*args, stream):
                raise SystemExit("raw chain launch failed (%s)"
                                 % fn.__name__)

    run.buffers = (out_ev, out)  # kept alive with the launcher
    return run


def chain_span(torch, run, reps=CHAIN_TIMING_REPS):
    """Device times of ``reps`` chains, each queued behind a sleep ->
    {"span_ms": median by CUDA events from the chain's first launch to
    its last kernel's end, "profiler": per-kernel durations and the
    span from the first K1's start to the last K1's end, read from a
    torch.profiler trace (None unless it holds every chain's three
    kernels in order), "profiler_kernels": how many it holds}."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    spans = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(CHAIN_SLEEP_CYCLES)
        start.record()
        run()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    span_ms = sorted(s.elapsed_time(e) for s, e in spans)[reps // 2]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            torch.cuda._sleep(CHAIN_SLEEP_CYCLES)
            run()
        torch.cuda.synchronize()
    path = os.path.join(HERE, "build", "chain_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    names = (TIER_PROFILE_PREFIX["k1"], TIER_PROFILE_PREFIX["k2"])
    kernels = sorted((e for e in events if e.get("ph") == "X"
                      and str(e.get("name", "")).startswith(names)),
                     key=lambda e: float(e["ts"]))
    out = {"span_ms": span_ms, "profiler": None,
           "profiler_kernels": len(kernels)}
    chains = [kernels[i:i + 3] for i in range(0, len(kernels), 3)]
    if len(kernels) != 3 * reps or any(
            not c[1]["name"].startswith(names[1]) for c in chains):
        return out

    def median(values):
        return sorted(values)[len(values) // 2]

    def end(e):
        return float(e["ts"]) + float(e["dur"])

    out["profiler"] = {
        "span_ms": median([(end(c[2]) - float(c[0]["ts"])) / 1e3
                           for c in chains]),
        "k1_evict_ms": median([float(c[0]["dur"]) / 1e3 for c in chains]),
        "k2_ms": median([float(c[1]["dur"]) / 1e3 for c in chains]),
        "k1_combined_ms": median([float(c[2]["dur"]) / 1e3 for c in chains]),
        # a start before the previous kernel's end is the overlap PDL buys
        "k2_start_after_k1_end_ms": median(
            [(float(c[1]["ts"]) - end(c[0])) / 1e3 for c in chains]),
        "k1_start_after_k2_end_ms": median(
            [(float(c[2]["ts"]) - end(c[1])) / 1e3 for c in chains]),
    }
    return out


def chain_timing(torch, np, tier, serial_lib):
    """The chunk chain at deepfm's shapes (512-row chunk, 8192 slots,
    adam; d 8 and d 1) with programmatic dependent launch (the
    checkout's library) against the serial chain (``serial_lib``, built
    from K1_CHAIN_VARIANTS["serial"]), in turns (pdl, serial, serial,
    pdl), by ``chain_span``; with the wrapper ``fused_insert_gather``
    timed by events beside it (host-bound: Python between launches)."""
    from elasticdl_tpu_torch.ops import _build

    libs = {"pdl": _build.load("embedding_tier"), "serial": serial_lib}
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    results = {}
    for table, dim in TIER_DIMS:
        state, t = chain_inputs(torch, np, np.random.default_rng(SEED + 6),
                                dim)
        record = {"table": table, "dim": dim, "staged": TIER_STAGED,
                  "combined": int(t["slots"].shape[0]),
                  "pdl": [], "serial": []}
        for key in ("pdl", "serial", "serial", "pdl"):
            record[key].append(chain_span(
                torch, chain_launcher(torch, libs[key], state, t)))
        record["wrapper_ms"] = time_ms(
            torch, lambda: tier.fused_insert_gather(
                state, t["ins"], t["ins_rows"], t["evict"], t["slots"],
                t["miss"]), flush)
        log(json.dumps({"tier_chain_timing": record}))
        results[table] = record
    return results


# sparse train phase: DeepFM through SparseTrainer at the deployment
# configuration of bench.py:65-78,106-129 (39 fields, batch 512, id
# capacity min(512 * 39, 8192), ids Zipf(1.2) % 1e6 from numpy seed 0,
# adam lr 0.001 on the PS and the tier)
SPARSE_BATCH = 512
SPARSE_FIELDS = 39
SPARSE_VOCAB = 1_000_000
SPARSE_STEPS = 110
SPARSE_TIER = dict(capacity=65536, promote_hits=2, ttl=4096,
                   stage_budget=2048, opt_type="adam",
                   opt_args={"lr": 0.001}, writeback_steps=256)
SPARSE_SMALL_CAPACITY = 4096
SPARSE_SMALL_STEPS = 8
# card against CPU over the first steps, same batches, same seed: fp32
# throughout (TF32 off), so the two differ in summation order only
# (cuBLAS against the CPU's BLAS, the index backward's scatter-add).
# Adam near its eps divides such noise by eps (the dense slice's
# finding), so this run sets eps 1e-3 on the dense params, the PS and
# the tier: an update then moves by at most the gradient's own noise.
# The loss to 1e-5 relative; the touched store rows and the tier's
# rows to 1e-5 relative, 1e-6 absolute (their init scale is 1e-3; a
# wrong optimizer step moves a row by about lr = 1e-3).
SPARSE_AGREE_STEPS = 3
SPARSE_AGREE_EPS = 1e-3
SPARSE_LOSS_RTOL = 1e-5
SPARSE_ROW_RTOL, SPARSE_ROW_ATOL = 1e-5, 1e-6
SPARSE_NEVER_STEPS = 3
SPARSE_REPEAT_STEPS = 5
# the host stage split: medians over this many fresh steps, per store
SPARSE_SPLIT_STEPS = 10


def ctr_batches(np, n, batch=SPARSE_BATCH, fields=SPARSE_FIELDS,
                vocab=SPARSE_VOCAB, seed=SEED):
    """bench.py's Zipfian CTR batches: ids Zipf(1.2) % vocab, random
    labels, all rows real."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = (rng.zipf(1.2, size=(batch, fields)) % vocab).astype(np.int64)
        out.append({
            "features": {"ids": ids},
            "labels": rng.randint(0, 2, batch).astype(np.float32),
            "_mask": np.ones(batch, np.float32),
        })
    return out


def sparse_trainer(device, batch, fields, tier=None, eps=None,
                   numpy_store=False):
    """DeepFM's SparseTrainer over an in-process store (adam lr 0.001,
    as bench.py's PS), seed 0: the store ``LocalPSClient`` picks (the
    native one, through ``create_store``) or, with ``numpy_store``, a
    ``NumpyEmbeddingStore``; ``tier`` a dict of DeviceTierConfig knobs
    or None; ``eps`` overrides adam's epsilon on the dense params, the
    PS and the tier."""
    from elasticdl_tpu_torch.models import deepfm
    from elasticdl_tpu_torch.ps.embedding_store import NumpyEmbeddingStore
    from elasticdl_tpu_torch.ps.local_client import LocalPSClient
    from elasticdl_tpu_torch.train.device_tier import DeviceTierConfig
    from elasticdl_tpu_torch.train.optimizers import create_optimizer
    from elasticdl_tpu_torch.train.sparse import SparseTrainer

    eps_args = {} if eps is None else {"epsilon": eps}
    config = False
    if tier is not None:
        knobs = dict(tier)
        knobs["opt_args"] = {**knobs["opt_args"], **eps_args}
        config = DeviceTierConfig(**knobs)
    if numpy_store:
        store = NumpyEmbeddingStore(seed=SEED)
        store.set_optimizer("adam", lr=0.001, **eps_args)
        client = LocalPSClient(store=store)
    else:
        client = LocalPSClient(seed=SEED, opt_type="adam", lr=0.001,
                               **eps_args)
    return SparseTrainer(
        model=deepfm.custom_model(),
        loss_fn=deepfm.loss,
        optimizer=create_optimizer("Adam", learning_rate=0.001, **eps_args),
        specs=deepfm.sparse_embedding_specs(
            num_features=fields, batch_size=batch,
            capacity=min(batch * fields, deepfm.MAX_ID_CAPACITY)),
        ps_client=client,
        seed=SEED,
        device_tier=config,
        device=device,
    )


def store_record(trainer):
    """Which store ``trainer`` trains on: its class and its library."""
    store = trainer.preparer._ps.store
    return {"store": type(store).__name__,
            "library": getattr(store, "library_path", None)}


def tier_counts(tier):
    return (tier.GATHER_LAUNCHES, tier.SET_ROWS_LAUNCHES,
            tier.SCATTER_APPLY_LAUNCHES)


def reset_tier_launches(tier):
    tier.GATHER_LAUNCHES = tier.SET_ROWS_LAUNCHES = 0
    tier.SCATTER_APPLY_LAUNCHES = 0


def sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def sparse_phase(torch, np, tier, device="cuda", batch=SPARSE_BATCH,
                 fields=SPARSE_FIELDS, vocab=SPARSE_VOCAB, steps=SPARSE_STEPS,
                 tier_knobs=None, small_capacity=SPARSE_SMALL_CAPACITY):
    """DeepFM through the port's SparseTrainer with the device tier, and
    its checks (each printed; any failure raises SystemExit): the
    never-promote tier bit-exact with the tier off; the card against
    the CPU over the first steps; the main run's finite losses, K1-K3
    launches per step against the path's formula and a warm hit rate
    above 0; a small tier's evictions and flush parity; the loss
    falling on one repeated batch. Returns what the kernels line and
    the timing need."""
    knobs = dict(SPARSE_TIER if tier_knobs is None else tier_knobs)
    device = torch.device(device)
    # the main run's batches, the repeated batch, and fresh ones for the
    # profiled step (up to three, see sparse_timing) and the host split
    batches = ctr_batches(np, steps + 4 + SPARSE_SPLIT_STEPS, batch, fields,
                          vocab)
    tables = ("deepfm_emb", "deepfm_linear")

    # 1. an engaged tier that never promotes is the tier-off path
    never = dict(knobs, promote_hits=10 ** 9)
    losses = {}
    for name, tier_cfg in (("off", None), ("never", never)):
        trainer = sparse_trainer(device, batch, fields, tier=tier_cfg)
        state, run = None, []
        for b in batches[:SPARSE_NEVER_STEPS]:
            state, loss = trainer.train_step(state, b)
            run.append(float(loss))
        losses[name] = run
        trainer.close()
        del trainer, state
    record = {"sparse": "never_promote_vs_tier_off", "losses_off":
              losses["off"], "losses_never": losses["never"],
              "bit_exact": losses["off"] == losses["never"]}
    log(json.dumps(record))
    if not record["bit_exact"]:
        raise SystemExit("a never-promoting tier changed the losses")

    # 2. the card against the CPU on the same batches (plain versions)
    runs = []
    for dev in (device, torch.device("cpu")):
        trainer = sparse_trainer(dev, batch, fields, tier=knobs,
                                 eps=SPARSE_AGREE_EPS)
        state, run = None, []
        for b in batches[:SPARSE_AGREE_STEPS]:
            state, loss = trainer.train_step(state, b)
            run.append(float(loss))
        touched = np.unique(np.concatenate(
            [b["features"]["ids"].ravel()
             for b in batches[:SPARSE_AGREE_STEPS]]))
        store = trainer.preparer._ps.store
        runs.append({
            "losses": run, "store": store_record(trainer),
            "rows": {t: store.lookup(t, touched) for t in tables},
            "tier": {t: trainer.device_tier.table_rows(t) for t in tables},
            "stats": trainer.device_tier.stats(),
        })
        trainer.close()
        del trainer, state
    card, cpu = runs
    if card["store"] != cpu["store"]:
        raise SystemExit("card and CPU trained on other stores: %s, %s"
                         % (card["store"], cpu["store"]))
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(card["losses"], cpu["losses"]))
    row_err, rows_ok = 0.0, card["stats"] == cpu["stats"]
    for t in tables:
        pairs = [(card["rows"][t], cpu["rows"][t]),
                 (card["tier"][t][1], cpu["tier"][t][1])]
        rows_ok = rows_ok and np.array_equal(card["tier"][t][0],
                                             cpu["tier"][t][0])
        for got, want in pairs:
            if got.shape != want.shape:
                rows_ok = False
                continue
            diff = np.abs(got.astype(np.float64) - want)
            row_err = max(row_err, float(diff.max()) if diff.size else 0.0)
            rows_ok = rows_ok and bool((diff <= SPARSE_ROW_ATOL
                                        + SPARSE_ROW_RTOL
                                        * np.abs(want)).all())
    record = {"sparse": "card_vs_cpu", "steps": SPARSE_AGREE_STEPS,
              "losses": card["losses"], "cpu_losses": cpu["losses"],
              "loss_rel_err": loss_err, "tol_loss_rel": SPARSE_LOSS_RTOL,
              "row_max_abs_err": row_err, "tol_row_rel": SPARSE_ROW_RTOL,
              "tol_row_abs": SPARSE_ROW_ATOL, "rows_ok": rows_ok,
              "adam_eps": SPARSE_AGREE_EPS, **card["store"],
              "resident": {t: int(card["tier"][t][0].size) for t in tables}}
    log(json.dumps(record))
    if not (loss_err <= SPARSE_LOSS_RTOL and rows_ok):
        raise SystemExit("the card disagrees with the CPU on the sparse "
                         "path")
    del runs, card, cpu

    # 3. the main run: the deployment configuration over distinct batches,
    # on the store a user gets (the native one; create_store's fallback
    # to numpy fails the run here)
    trainer = sparse_trainer(device, batch, fields, tier=knobs)
    used = store_record(trainer)
    log(json.dumps({"sparse": "main_run_store", **used}))
    if used["store"] != "NativeEmbeddingStore":
        raise SystemExit("the sparse path trains on %s, not the native "
                         "store" % used["store"])
    dtier = trainer.device_tier
    state, main_losses, step_s, bad_steps = None, [], [], []
    half_stats = None
    reset_tier_launches(tier)  # the sparse path's count starts here
    for i, b in enumerate(batches[:steps]):
        before = tier_counts(tier)
        stats0 = dtier.stats()
        t0 = time.monotonic()
        state, loss = trainer.train_step(state, b)
        main_losses.append(float(loss))
        step_s.append(time.monotonic() - t0)
        stats1 = dtier.stats()
        d_k1, d_k2, d_k3 = (a - c for a, c in zip(tier_counts(tier), before))
        gather_only = (stats1["gather_only_combines"]
                       - stats0["gather_only_combines"])
        # per staging chunk: K1 for the combined buffer, K1 for the
        # victims if it has any, K2 once (the whole table state) if it
        # has promotions
        chunks, inserts, evicts = (
            stats1[k] - stats0[k]
            for k in ("staged_chunks", "insert_chunks", "evict_chunks"))
        want = (gather_only + chunks + evicts, inserts, len(tables))
        if (d_k1, d_k2, d_k3) != want:
            bad_steps.append([i, [d_k1, d_k2, d_k3], list(want)])
        if i + 1 == steps // 2:
            half_stats = dtier.stats()
    sync(torch, device)
    launches = dict(zip(("gather", "insert_rows", "scatter_apply"),
                        tier_counts(tier)))
    end_stats = dtier.stats()
    warm_lookups = (end_stats["hits"] + end_stats["misses"]
                    - half_stats["hits"] - half_stats["misses"])
    warm_hit_rate = (end_stats["hits"] - half_stats["hits"]) / max(
        warm_lookups, 1)
    warm = step_s[10:] or step_s
    main_record = {
        "sparse": "main_run", "steps": len(main_losses), "batch": batch,
        "fields": fields, "tier": knobs, "launches": launches,
        "launches_per_step": {k: v / len(main_losses)
                              for k, v in launches.items()},
        "launch_formula_mismatches": bad_steps[:5],
        "losses_first_last": [main_losses[0], main_losses[-1]],
        "all_finite": bool(np.isfinite(main_losses).all()),
        "warm_hit_rate": warm_hit_rate, "tier_stats": end_stats,
        "steps_per_s": len(warm) / sum(warm),
        "examples_per_s": batch * len(warm) / sum(warm),
        "step_ms_host_median": float(np.median(warm)) * 1e3, **used,
    }
    log(json.dumps(main_record))
    if not main_record["all_finite"] or len(main_losses) != steps:
        raise SystemExit("sparse losses: %s" % main_losses)
    if bad_steps or min(launches.values()) <= 0:
        raise SystemExit("K1-K3 launches do not follow the path: %s"
                         % bad_steps[:5])
    if not warm_hit_rate > 0:
        raise SystemExit("the tier served no hit once warm")

    # 4. the loss falls on one repeated batch
    repeated = []
    for _ in range(SPARSE_REPEAT_STEPS):
        state, loss = trainer.train_step(state, batches[steps])
        repeated.append(float(loss))
    log(json.dumps({"sparse": "repeated_batch", "losses": repeated}))
    if not repeated[-1] < repeated[0]:
        raise SystemExit("the sparse loss did not fall on a repeated batch")

    # 5. a small tier: evictions, then flush parity after close()
    small = sparse_trainer(device, batch, fields,
                           tier=dict(knobs, capacity=small_capacity))
    small_state = None
    for b in batches[:SPARSE_SMALL_STEPS]:
        small_state, _ = small.train_step(small_state, b)
    small.close()
    store = small.preparer._ps.store
    parity, resident = True, {}
    for t in tables:
        ids, rows = small.device_tier.table_rows(t)
        resident[t] = int(ids.size)
        parity = parity and ids.size > 0 and np.array_equal(
            rows, store.lookup(t, ids))
    small_stats = small.device_tier.stats()
    record = {"sparse": "small_tier_flush_parity",
              "capacity": small_capacity, "steps": SPARSE_SMALL_STEPS,
              "evictions": small_stats["evictions"], "resident": resident,
              "bit_exact": parity, "tier_stats": small_stats}
    log(json.dumps(record))
    if not (small_stats["evictions"] > 0 and parity):
        raise SystemExit("small tier: no evictions or flush parity broken")
    del small, small_state
    return {"trainer": trainer, "state": state,
            "replay_batches": batches[:steps] + [batches[steps]]
            * SPARSE_REPEAT_STEPS,
            "profile_batches": batches[steps + 1:steps + 4],
            "split_batches": batches[steps + 4:], "launches": launches,
            "steps": len(main_losses), "main": main_record,
            "knobs": knobs, "batch": batch, "fields": fields}


# the profiler's demangled names of K1-K3 (ops/csrc/embedding_tier.cu),
# matched from the start: torch's own gathers (e.g.
# at::native::vectorized_gather_kernel) contain "gather_kernel" too
TIER_PROFILE_PREFIX = {
    "k1": "void (anonymous namespace)::gather_kernel<",
    "k2": "void (anonymous namespace)::insert_rows_kernel<",
    "k3": "void (anonymous namespace)::scatter_apply_kernel<",
}


def profile_step(torch, tier, trainer, state, batch):
    """One train step under torch.profiler -> (state, record, counted,
    profiled): its wall time beside the device-busy time, the idle
    share, the K1-K3 share of busy time, and each of K1-K3's launches by
    its counter and by the profiler (None when the profiler sees no
    device time). The profiler traces the card alone: with CPU activity
    on as well, some processes lost the record of one tier kernel (a K1,
    or a K2) in every profiled step, while the card-only traces of the
    chain in the same processes held every kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = tier_counts(tier)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    counted = dict(zip(("k1", "k2", "k3"),
                       (a - b for a, b in zip(tier_counts(tier), before))))
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        total_us = getattr(evt, "device_time_total", None)
        if total_us is None:
            total_us = evt.cuda_time_total
        kernels[evt.key] = (total_us / 1e3, evt.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    k_ms, k_launches = {}, {}
    for k, prefix in TIER_PROFILE_PREFIX.items():
        rows = [v for key, v in kernels.items() if key.startswith(prefix)]
        k_ms[k] = sum(ms for ms, _ in rows)
        k_launches[k] = sum(n for _, n in rows)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    record = {"profile": "sparse_train_step", "wall_ms": wall_ms,
              "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
              "counted_launches": counted}
    if busy_ms <= 0:
        return state, record, counted, None
    record.update({
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "k1_k3_ms": sum(k_ms.values()), **{k + "_ms": v
                                            for k, v in k_ms.items()},
        "profiled_launches": k_launches,
        "k1_k3_share_of_busy": sum(k_ms.values()) / busy_ms,
        "top": [[key[:90], ms, n] for key, (ms, n) in top],
    })
    return state, record, counted, k_launches


def sparse_timing(torch, tier, sparse):
    """One step on a fresh batch (as the main run's: misses pulled and
    pushed, promotions staged) profiled (``profile_step``), each of
    K1-K3's profiled launches held against its launch counter over the
    step. A profiled launch more than counted fails at once. Fewer can
    be the profiler's loss (on a loaded host CUPTI has dropped a K2
    launch and the copy beside it from a step whose counters and
    results were right): then another fresh step is profiled, up to
    len(sparse["profile_batches"]), and one must match. Returns the
    state after the steps."""
    state = sparse["state"]
    for attempt, batch in enumerate(sparse["profile_batches"]):
        state, record, counted, profiled = profile_step(
            torch, tier, sparse["trainer"], state, batch)
        log(json.dumps(dict(record, attempt=attempt)))
        if profiled is None or profiled == counted:
            return state
        if any(profiled[k] > counted[k] for k in counted):
            break
    raise SystemExit("the profiled K1-K3 launches %s are not the counted "
                     "ones %s" % (profiled, counted))


SPLIT_TOP = ("prepare", "combine", "step", "apply_extract", "push")


def _split_stages(trainer):
    """(stage, owner, attribute) of the trainer's own calls that
    ``sparse_host_split`` times: ``prepare`` (unique ids, tier lookup
    and admission, and the PS ``pull`` of the misses, shown on its own
    too), ``combine`` (the miss rows to the card, K1/K2), ``step``
    (forward, backward, dense update), ``apply_extract`` (K3, the miss
    gradients to the host) and ``push`` (the PS optimizer step)."""
    return (("prepare", trainer.preparer, "prepare"),
            ("pull", trainer.preparer._embedding, "pull_tables"),
            ("combine", trainer, "_tier_combine"),
            ("step", trainer, "_train_step"),
            ("apply_extract", trainer, "_tier_apply_extract"),
            ("push", trainer.preparer, "push_gradients"))


def sparse_host_split(torch, runs, batches):
    """One step of each trainer of ``runs`` ({label: [trainer, state]})
    on each of ``batches`` (fresh ones), in turns (the order flips from
    batch to batch), timed stage by stage through the trainer's own
    calls (``_split_stages``; each wrapped with a timer that waits for
    the card at its end). Updates the states in ``runs``; logs and
    returns {label: record} with each stage's median over the steps
    and the steps' wall times."""
    import numpy as np

    steps = {label: [] for label in runs}  # label -> [{stage: ms}, ...]
    current = {}

    def timed(label, name, fn):
        def run(*args, **kwargs):
            t0 = time.monotonic()
            out = fn(*args, **kwargs)
            sync(torch, runs[label][0].device)
            stage = current[label]
            stage[name] = stage.get(name, 0.0) + (time.monotonic() - t0) * 1e3
            return out
        return run

    saved = []
    for label, (trainer, _) in runs.items():
        for name, owner, attr in _split_stages(trainer):
            saved.append((owner, attr, owner.__dict__.get(attr)))
            setattr(owner, attr, timed(label, name, getattr(owner, attr)))
    walls = {label: [] for label in runs}
    try:
        order = list(runs)
        for i, batch in enumerate(batches):
            for label in order if i % 2 == 0 else order[::-1]:
                trainer, state = runs[label]
                current[label] = {}
                sync(torch, trainer.device)
                t0 = time.monotonic()
                runs[label][1], _ = trainer.train_step(state, batch)
                sync(torch, trainer.device)
                walls[label].append((time.monotonic() - t0) * 1e3)
                steps[label].append(current[label])
    finally:
        for owner, attr, own in saved:
            if own is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, own)

    def median(values):
        return float(np.median(values))

    records = {}
    for label, per_step in steps.items():
        names = sorted({k for step in per_step for k in step})
        records[label] = {
            "profile": "sparse_host_split", "store": label,
            "steps": len(per_step),
            "wall_ms_median": median(walls[label]),
            "wall_ms": walls[label],
            "stage_ms_median": {k: median([step.get(k, 0.0)
                                           for step in per_step])
                                for k in names},
            "other_ms_median": median([
                wall - sum(step.get(k, 0.0) for k in SPLIT_TOP)
                for wall, step in zip(walls[label], per_step)]),
        }
        log(json.dumps(records[label]))
    return records


def store_splits(torch, sparse):
    """The host stage split for each store on this card, in one run:
    the main run's trainer (the native store) and a trainer on the numpy
    store that first replays the main run's steps and the repeated
    batch (the same id stream, so the same tier state), timed in turns
    over the same SPARSE_SPLIT_STEPS fresh batches (``sparse_host_split``).
    Updates ``sparse["state"]``; returns the records by store."""
    main = sparse["trainer"]
    numpy_trainer = sparse_trainer(main.device, sparse["batch"],
                                   sparse["fields"], tier=sparse["knobs"],
                                   numpy_store=True)
    state = None
    for batch in sparse["replay_batches"]:
        state, _ = numpy_trainer.train_step(state, batch)
    runs = {store_record(main)["store"]: [main, sparse["state"]],
            store_record(numpy_trainer)["store"]: [numpy_trainer, state]}
    records = sparse_host_split(torch, runs, sparse["split_batches"])
    sparse["state"] = runs[store_record(main)["store"]][1]
    numpy_trainer.close()
    return records


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


K4_SOURCE = "elasticdl_tpu_torch/ops/csrc/flash_fwd.cu"
# faults planted in a copy of K4's source by ``--mutations``: (name,
# ((source text, its replacement), ...)); kernel_phase must fail on each
K4_MUTATIONS = (
    ("skip_diagonal_tile", (
        ("return causal ? q_last / kBlockN + 1 :",
         "return causal ? max(q_last / kBlockN, 1) :"),)),
    ("no_output_correction", (
        ("acc_o[i] *= corr[(i >> 1) & 1];", "acc_o[i] *= 1.f;"),)),
    ("wrong_ring_stage", (
        ("const uint32_t k_src = k_s + stage * L::kTileBytes;",
         "const uint32_t k_src = k_s + ((stage + 1) % kStages) "
         "* L::kTileBytes;"),)),
)
# K4's persistent tile loop (one CTA per SM walks the work tiles,
# longest first) against one CTA per work tile, launched longest first or
# head by head (each head's query tiles in order)
K4_ONE_TILE_PER_CTA = (
    ("const int grid = n_work < sms ? n_work : sms;",
     "const int grid = n_work;"),)
K4_SCHEDULES = {
    "persistent": (),
    "one_tile_per_cta": K4_ONE_TILE_PER_CTA,
    "one_tile_per_cta_head_major": K4_ONE_TILE_PER_CTA + (
        ("  bh = t % bh_count;\n  q0 = (m_tiles - 1 - t / bh_count) * kBlockM;",
         "  bh = t / m_tiles;\n  q0 = (t % m_tiles) * kBlockM;"),),
}

BWD_SOURCE = "elasticdl_tpu_torch/ops/csrc/flash_bwd.cu"
# faults planted in a copy of K5/K6's source: bwd_kernel_phase must fail
# on each (K6's query mask matters only where a query tile is ragged:
# the S = 1000 cases)
BWD_MUTATIONS = (
    ("k5_skip_diagonal_tile", (
        ("return causal ? q_last / kN + 1 :",
         "return causal ? max(q_last / kN, 1) :"),)),
    ("k5_no_delta", (
        ("ds[e] = p * (acc_dp[j + e] - delta_r[h]) * scale;",
         "ds[e] = p * acc_dp[j + e] * scale;"),)),
    ("k6_no_query_mask_past_s", (
        ("if (q_pos >= seq || (causal && k_pos > q_pos)) s = kNegInf;",
         "if (causal && k_pos > q_pos) s = kNegInf;"),)),
    ("k6_q_wrong_ring_stage", (
        ("const uint32_t q_src = q_s + stage * L::kTileBytes;",
         "const uint32_t q_src = q_s + ((stage + 1) % kStages) "
         "* L::kTileBytes;"),)),
)
TIER_SOURCE = "elasticdl_tpu_torch/ops/csrc/embedding_tier.cu"
K3_HIT = "const bool hit = s >= 0 && s < table_rows - 1;"
K1_IN_TABLE = "  const bool in_table = s >= 0 && s < table_rows;\n"
K1_TABLE_LOAD = "      v = __ldcg(table_row + c);\n"
K1_RACE = "k1_table_read_before_wait"
# the race's child runs: each is one tier_kernel_phase (its chain check
# makes CHAIN_REPS runs of the chain at each width)
K1_RACE_RUNS = 3
# faults planted in a copy of K1-K3's source: tier_kernel_phase's checks
# must fail on each (K3's count fault shows where a row has two lanes or
# more: d 8, not d 1)
TIER_MUTATIONS = (
    ("k2_skips_second_slot_buffer", (
        ("    if (slot1 != nullptr) reinterpret_cast<T*>(slot1)[base + c] "
         "= C::zero();\n", ""),)),
    ("k2_keeps_step_count", (
        ("  if (lane == 0 && steps != nullptr) steps[s] = 0;\n", ""),)),
    ("k3_lanes_reread_step_count", (
        ("  if (OPT == kAdam) {\n"
         "    bc1 = __shfl_sync(live, c1, 0, group);\n"
         "    bc2 = __shfl_sync(live, c2, 0, group);\n"
         "  }\n"
         "  if (lane == 0) steps[s] = t;\n",
         "  if (lane == 0) steps[s] = t;\n"
         "  __syncwarp(live);\n"
         "  if (lane != 0) t = steps[s] + 1;\n"
         "  if (OPT == kAdam) {\n"
         "    bc1 = __fsub_rn(1.0f, powf(h.beta1, (float)t));\n"
         "    bc2 = __fsub_rn(1.0f, powf(h.beta2, (float)t));\n"
         "  }\n"),)),
    ("k3_miss_to_slot_0", (
        (K3_HIT, "if (s < 0 || s >= table_rows - 1) s = 0;\n"
                 "  const bool hit = true;"),)),
    ("k1_miss_reads_slot_0", (
        (K1_IN_TABLE, "  if (s < 0 || s >= table_rows) s = 0;\n"
                      "  const bool in_table = true;\n"),)),
    ("k1_lane_reads_wrong_chunk", (
        (K1_TABLE_LOAD, "      v = __ldcg(table_row + (c + 1) % chunks);\n"),)),
    # a race: K1 of the combined buffer may read a row before K2 of the
    # chain has written it; tier_kernel_phase's chain check counts the
    # runs that saw it
    (K1_RACE, (
        ("  wait_for_previous_grid();\n  if (!live) return;\n" + K1_IN_TABLE,
         "  if (!live) return;\n" + K1_IN_TABLE
         + "  T early = C::zero();\n"
         "  if (in_table && lane < chunks)\n"
         "    early = __ldcg(reinterpret_cast<const T*>(table) +\n"
         "                   (long long)s * chunks + lane);\n"
         "  wait_for_previous_grid();\n"),
        (K1_TABLE_LOAD, "      v = c == lane ? early : __ldcg(table_row + c);"
                        "\n"))),
)
# K3 as it is (a miss returns at once) against K3 sending every miss to
# the scratch row, as the reference does: timed in turns on the real mix
# and on all hits
K3_VARIANTS = {
    "misses_return": (),
    "misses_to_scratch": (
        (K3_HIT, "if (s < 0 || s >= table_rows - 1) s = table_rows - 1;\n"
                 "  const bool hit = true;"),),
}
# a child run in a copy: K4's kernel_phase at every case ("check") or
# the main case alone ("time"), bwd_kernel_phase's checks at every case
# ("bwd"), tier_kernel_phase's checks ("tier"), or K3's hit-mix timing
# ("tier_time")
MUTATION_CHILD = (
    "import sys, numpy as np, torch, chip_smoke\n"
    "from elasticdl_tpu_torch.ops import embedding_tier as tier\n"
    "from elasticdl_tpu_torch.ops import flash_attention as flash\n"
    "mode = sys.argv[1]\n"
    "if mode == 'bwd':\n"
    "    chip_smoke.bwd_kernel_phase(torch, flash, timing=False)\n"
    "elif mode == 'tier':\n"
    "    chip_smoke.tier_kernel_phase(torch, np, tier, timing=False)\n"
    "elif mode == 'tier_time':\n"
    "    chip_smoke.k3_hit_mix_timing(torch, np)\n"
    "else:\n"
    "    cases = chip_smoke.CASES[:1] if mode == 'time' "
    "else chip_smoke.CASES\n"
    "    chip_smoke.kernel_phase(torch, flash, cases, baselines=False)\n"
)


def apply_edits(text, edits, name):
    """``text`` with each (old, new) of ``edits`` replaced; raises unless
    every old text occurs exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit("%s: %r is not in the source exactly once"
                             % (name, old))
        text = text.replace(old, new)
    return text


def kernel_copy(name, source, edits):
    """The port and this script copied under build/mut_<name>, with
    ``edits`` applied to the kernel source ``source`` (a path from the
    checkout's root); the copy builds its own library (the name carries
    the source's hash)."""
    root = os.path.join(HERE, "build", "mut_" + name)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    for name_ in ("chip_smoke.py", "pyproject.toml"):
        shutil.copy(os.path.join(HERE, name_), root)
    shutil.copytree(os.path.join(HERE, "elasticdl_tpu_torch"),
                    os.path.join(root, "elasticdl_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, source)
    with open(path) as f:
        text = apply_edits(f.read(), edits, name)
    with open(path, "w") as f:
        f.write(text)
    return root


def mutation_child(root, mode):
    return subprocess.run([sys.executable, "-c", MUTATION_CHILD, mode],
                          cwd=root, capture_output=True, text=True,
                          timeout=900)


def mutation_phase():
    """Plant each of K4_MUTATIONS, BWD_MUTATIONS and TIER_MUTATIONS in
    its own copy and require kernel_phase (K4), bwd_kernel_phase (K5,
    K6) or tier_kernel_phase (K1-K3) to fail there. K1_RACE is a race:
    its copy runs K1_RACE_RUNS times, each run's chain mismatches are
    logged, and it counts as missed only if no run caught it. Then time
    K4 at the main case under each of K4_SCHEDULES, in turns (A B C C B
    A), and K3 under each of K3_VARIANTS (A B B A)."""
    # copy name -> (root, the child's mode); the backward's phase runs
    # K4 too, so its copies build both flash sources
    copies = {name: (kernel_copy(name, K4_SOURCE, edits), "check")
              for name, edits in K4_MUTATIONS}
    copies.update({name: (kernel_copy(name, BWD_SOURCE, edits), "bwd")
                   for name, edits in BWD_MUTATIONS})
    copies.update({name: (kernel_copy(name, TIER_SOURCE, edits), "tier")
                   for name, edits in TIER_MUTATIONS})
    schedules = {name: kernel_copy(name, K4_SOURCE, edits)
                 for name, edits in K4_SCHEDULES.items()}
    k3_variants = {name: kernel_copy("k3_" + name, TIER_SOURCE, edits)
                   for name, edits in K3_VARIANTS.items()}
    built = {"check": ["flash_fwd"], "bwd": ["flash_fwd", "flash_bwd"],
             "tier": ["embedding_tier"]}
    targets = [(root, built[mode]) for root, mode in copies.values()]
    targets += [(root, ["flash_fwd"]) for root in schedules.values()]
    targets += [(root, ["embedding_tier"]) for root in k3_variants.values()]
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from elasticdl_tpu_torch.ops import _build; "
         "_build.build(%r)" % kernels], cwd=root)
        for root, kernels in targets]
    if any(proc.wait() for proc in builds):
        raise SystemExit("a mutated copy did not build")
    missed, race = [], []
    for name, (root, mode) in copies.items():
        for _ in range(K1_RACE_RUNS if name == K1_RACE else 1):
            proc = mutation_child(root, mode)
            lines = (proc.stdout + proc.stderr).strip().splitlines()
            chain = [json.loads(line) for line in proc.stdout.splitlines()
                     if line.startswith('{"tier_chain"')]
            log(json.dumps({
                "mutation": name, "caught": proc.returncode != 0,
                "rc": proc.returncode,
                "chain_mismatches": [[r["dim"], r["mismatches"], r["reps"]]
                                     for r in chain],
                "last_line": lines[-1][:300] if lines else ""}))
            if name == K1_RACE:
                race.append(proc.returncode != 0)
            elif proc.returncode == 0:
                missed.append(name)
    log(json.dumps({"race": K1_RACE, "runs_caught": sum(race),
                    "runs": len(race)}))
    if not any(race):
        missed.append(K1_RACE)
    times = {key: [] for key in schedules}
    for key in [*schedules, *reversed(schedules)]:
        proc = mutation_child(schedules[key], "time")
        records = [json.loads(line) for line in proc.stdout.splitlines()
                   if line.startswith('{"case"')]
        if proc.returncode or not records:
            raise SystemExit("K4 (%s) failed:\n%s"
                             % (key, proc.stdout + proc.stderr))
        times[key].append(records[-1]["ms"])
    log(json.dumps({"k4_schedule_ms": times, "case": CASES[0][0]}))
    k3_times = {key: [] for key in k3_variants}
    for key in [*k3_variants, *reversed(k3_variants)]:
        proc = mutation_child(k3_variants[key], "tier_time")
        records = [json.loads(line) for line in proc.stdout.splitlines()
                   if line.startswith('{"k3_hit_mix"')]
        if proc.returncode or not records:
            raise SystemExit("K3 (%s) failed:\n%s"
                             % (key, proc.stdout + proc.stderr))
        k3_times[key].append(records[-1]["k3_hit_mix"])
    log(json.dumps({"k3_variant_ms": k3_times, "table": "deepfm_emb",
                    "opt": "adam"}))
    if missed:
        raise SystemExit("planted faults not caught: %s" % missed)


def kernel_entry(name, source, replaces, launches, case, kind):
    """One kernel's record of the kernels line, at the main shape. K5
    and K6 have no library call of their own (library_ms null); the
    backward of scaled_dot_product_attention, which computes what both
    compute, stands once, on K6's record, beside the two kernels' sum.
    Their wrapper_ms is one call of flash_attention_bwd, the one wrapper
    that launches them both (checks, delta, K5 and K6)."""
    if kind == "fwd":
        err, ms, plain_ms = case["max_abs_err"], case["ms"], case["plain_ms"]
        bound_ms, bound_by = case["bound_ms"], case["bound_by"]
        library_ms, wrapper_ms = case["library_ms"], case["wrapper_ms"]
    else:
        grads = ("dq",) if kind == "dq" else ("dk", "dv")
        err = max(case["max_abs_err"][g] for g in grads)
        ms, plain_ms = case["%s_ms" % kind], case["%s_plain_ms" % kind]
        bound_ms, bound_by = case["%s_bound" % kind]
        library_ms, wrapper_ms = None, case["wrapper_ms_dq_dk_dv"]
    entry = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "wrapper_ms": wrapper_ms,
    }
    if kind == "dkv":
        entry["ms_k5_k6"] = case["dq_ms"] + case["dkv_ms"]
        entry["library_ms_k5_k6"] = case["library_ms_dq_dk_dv"]
    return entry


def tier_kernel_entry(name, replaces, kind, tier_cases, sparse):
    """One device-tier kernel's record of the kernels line: times at
    the deepfm_emb table's shape (d 8; K3 under adam, the deployment's
    optimizer), launches from the sparse train path's main run, and the
    deepfm_linear (d 1) time beside; K3's all-hits times too."""
    emb = tier_cases[kind]["deepfm_emb"]
    lin = tier_cases[kind]["deepfm_linear"]
    if kind == "scatter_apply":
        emb, lin = emb["adam"], lin["adam"]
    launches = sparse["launches"][kind]
    entry = {
        "name": name, "route": "cuda", "source": TIER_SOURCE,
        "replaces": replaces, "launches": launches,
        "launches_per_step": launches / sparse["steps"],
        "max_abs_err": emb["max_abs_err"], "ms": emb["ms"],
        "wrapper_ms": emb["wrapper_ms"],
        "plain_ms": emb["plain_ms"], "bound_ms": emb["bound_ms"],
        "bound_by": emb["bound_by"], "library_ms": emb["library_ms"],
        "shape": emb["shape"], "ms_linear_d1": lin["ms"],
    }
    for key in ("library_calls", "real_mix_ms", "device_ms",
                "all_hits_ms", "real_mix_device_ms", "all_hits_device_ms",
                "real_mix_hits", "all_hits_hits"):
        if key in emb:
            entry[key] = emb[key]
    if kind == "gather":
        # the staging chunk's chain (K1 -> K2 -> K1) at d 8: median
        # device span by events and by the profiler, with programmatic
        # dependent launch and serial, in turns
        chain = tier_cases["chain_timing"]["deepfm_emb"]
        for key in ("pdl", "serial"):
            entry["chain_%s_span_ms" % key] = [r["span_ms"]
                                               for r in chain[key]]
            entry["chain_%s_profiled_span_ms" % key] = [
                (r["profiler"] or {}).get("span_ms") for r in chain[key]]
        entry["chain_wrapper_ms"] = chain["wrapper_ms"]
    return entry


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke runs on the GPU only", file=sys.stderr)
        return 2
    import numpy as np

    sys.path.insert(0, HERE)
    from elasticdl_tpu_torch.ops import _build
    from elasticdl_tpu_torch.ops import embedding_tier as tier
    from elasticdl_tpu_torch.ops import flash_attention as flash

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log("card: %s (%d visible); torch %s, CUDA %s" % (
        smi, torch.cuda.device_count(), torch.__version__, torch.version.cuda))
    if argv == ["--mutations"]:
        mutation_phase()
        log(smi)
        return 0
    if argv:
        print("usage: chip_smoke.py [--mutations]", file=sys.stderr)
        return 2

    # the serial chain's copy builds beside the checkout's kernels
    serial_root = kernel_copy("k1_chain_serial", TIER_SOURCE,
                              K1_CHAIN_VARIANTS["serial"])
    serial_build = subprocess.Popen(
        [sys.executable, "-c", "from elasticdl_tpu_torch.ops import _build; "
         "_build.build(['embedding_tier'])"], cwd=serial_root)
    build_s = _build.build()
    if serial_build.wait():
        raise SystemExit("the serial chain's copy did not build")
    log(json.dumps({"phase": "build", "seconds": build_s}))
    # ptxas's report per kernel entry: registers, shared memory, spills
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if any(key in line for key in ("Compiling entry", "Used", "spill")):
                log("ptxas %s: %s" % (name, line.strip()))

    cases = kernel_phase(torch, flash)
    bwd_cases = bwd_kernel_phase(torch, flash)
    tier_cases = tier_kernel_phase(torch, np, tier)
    serial_lib = _build.bind(_build.library_path(
        "embedding_tier", os.path.join(serial_root, TIER_SOURCE),
        os.path.join(serial_root, "build", "edl_kernels")), "embedding_tier")
    tier_cases["chain_timing"] = chain_timing(torch, np, tier, serial_lib)

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
        del train["trainer"], train["state"]
        gc.collect()
        torch.cuda.empty_cache()
        sparse = sparse_phase(torch, np, tier)
        store_splits(torch, sparse)
        sparse_timing(torch, tier, sparse)
        sparse["trainer"].close()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # launches: the train path's count, the slice's main path (the
    # serve path's K4 count is beside it)
    launches = train["launches"]
    main_case = "serve_bf16_causal"  # the served and the trained shape
    fwd = kernel_entry(
        "flash_attention_fwd", K4_SOURCE,
        "elasticdl_tpu/ops/flash_attention.py:66", launches["fwd"],
        cases[main_case], "fwd")
    fwd["launches_serve"] = serve_launches
    log(json.dumps({"kernels": [
        fwd,
        kernel_entry("flash_attention_bwd_dq", BWD_SOURCE,
                     "elasticdl_tpu/ops/flash_attention.py:229",
                     launches["dq"], bwd_cases[main_case], "dq"),
        kernel_entry("flash_attention_bwd_dkv", BWD_SOURCE,
                     "elasticdl_tpu/ops/flash_attention.py:293",
                     launches["dkv"], bwd_cases[main_case], "dkv"),
        tier_kernel_entry("embedding_tier_gather",
                          "elasticdl_tpu/ops/embedding_tier.py:163",
                          "gather", tier_cases, sparse),
        tier_kernel_entry("embedding_tier_insert_rows",
                          "elasticdl_tpu/ops/embedding_tier.py:197",
                          "insert_rows", tier_cases, sparse),
        tier_kernel_entry("embedding_tier_scatter_apply",
                          "elasticdl_tpu/ops/embedding_tier.py:253",
                          "scatter_apply", tier_cases, sparse),
    ]}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
