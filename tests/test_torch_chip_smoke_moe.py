"""chip_smoke.py's phase 19 (MoE on one card), rehearsed on the CPU at
small sizes: bench.py's MoE cut to 2 layers of 2 heads (d 256), 4
experts, S 64, batch 2, its matched dense arm, the compact dispatch
against the one-hot, the MoE through SpmdTrainer on a one-rank mesh (a
gloo group of one rank here, NCCL on the card) beside TorchTrainer's
steps, and the zoo's MoE LM (cut to 2 layers) as a LocalExecutor job
served once, with K4-K6 counted by wrapping their plain versions (the
CPU path counts no launch). Each check passes, and the phase refuses
four planted faults: K4 launched twice a layer, a compact combine 1%
off, a dense plan that reports an fsdp leaf where the mesh has none,
and a mesh step whose loss differs from the plain trainer's. The formulas and bounds the phase prints are
held to the numbers PERF.md states. What only the card can give (times,
peak memory, the profile) reads "not measured" here.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from elasticdl_tpu_torch.ops import moe as port_moe
from tests.test_torch_chip_smoke_heads256 import _counting

torch.set_num_threads(1)

SMALL = dict(widths=dict(vocab_size=256, num_layers=2, num_heads=2,
                         embed_dim=256),
             routing=dict(num_experts=4, top_k=2, capacity_factor=1.25),
             seq=64, batch=2, warmup=1, steps=2,
             zoo_widths=dict(vocab_size=256, num_layers=2, num_heads=2,
                             embed_dim=128, num_experts=4), zoo_seq=64)


def test_moe_phase_rehearses(tmp_path):
    with _counting(1) as flash:
        out = chip_smoke.moe_phase(torch, np, flash, str(tmp_path),
                                   device="cpu", **SMALL)
    moe, dense = out["moe"], out["dense"]
    want = [{"fwd": 2, "dq": 2, "dkv": 2}] * 3
    assert moe["launches_per_step"] == dense["launches_per_step"] == want
    assert moe["peak_mem_gb"] == dense["peak_mem_gb"] == "not measured"
    assert dense["mlp_ratio"] == 7
    assert out["compact"]["ok"]
    assert max(out["compact"]["loss_rel_diff"]) <= chip_smoke.MOE_COMPACT_RTOL
    load = moe["expert_load"]
    assert np.isfinite(load["aux_loss"]) and load["capacity"] == 40
    (layer,) = load["layers"]  # one MoE block of two
    assert abs(sum(layer["first_choice_share"]) - 1.0) < 1e-6
    assert 0.0 <= layer["dropped_share"] < 1.0
    for arm in ("moe", "dense"):
        agreement = out["agreement"][arm]
        assert agreement["loss_abs_diff"] <= chip_smoke.TRAIN_LOSS_TOL
        assert agreement["grad_cosine"] >= chip_smoke.TRAIN_GRAD_COS
    zoo = out["zoo"]
    assert zoo["launches"] == {"fwd": 6, "dq": 6, "dkv": 6}
    assert zoo["serve_k4_launches"] == 2
    assert zoo["served_shape"] == [1, 64, 256] and zoo["served_step"] == 3
    assert out["summary"]["moe_step_overhead_vs_dense"] > 0
    mesh = out["mesh"]
    assert mesh["ok"] and mesh["mesh"] == "dp=1"
    assert mesh["backend"] == "gloo" and mesh["world"] == 1
    assert mesh["mesh_losses"] == mesh["plain_losses"]
    assert mesh["params_bit_equal"] and mesh["adam_slots_bit_equal"]
    assert mesh["launches_per_step"] == [{"fwd": 2, "dq": 2, "dkv": 2}] * 3
    assert mesh["plan"]["local_params"] == sum(
        1 for _ in chip_smoke_model_params())
    assert mesh["collective_bytes_per_step"] == 0.0
    assert mesh["recorded_collective_bytes"] == 0
    # the arm destroyed the group it started
    assert not torch.distributed.is_initialized()


def chip_smoke_model_params():
    from elasticdl_tpu_torch.models.moe_transformer import MoeTransformerLM

    with torch.device("meta"):
        model = MoeTransformerLM(mlp_ratio=chip_smoke.MOE_MLP_RATIO,
                                 **SMALL["widths"], **SMALL["routing"])
    return model.parameters()


def test_moe_phase_fails_on_an_fsdp_leaf_the_mesh_lacks(tmp_path,
                                                         monkeypatch):
    from elasticdl_tpu_torch.parallel import spmd_trainer

    plan = spmd_trainer.plan_dense_plane

    def planted(*args, **kwargs):
        out = plan(*args, **kwargs)
        out.params[0].mode = "reduce_scatter"
        return out

    monkeypatch.setattr(spmd_trainer, "plan_dense_plane", planted)
    with _counting(1) as flash, pytest.raises(
            SystemExit, match="mesh plan all local"):
        chip_smoke.moe_phase(torch, np, flash, str(tmp_path), device="cpu",
                             **SMALL)
    assert not torch.distributed.is_initialized()


def test_moe_phase_fails_on_a_mesh_loss_off(tmp_path, monkeypatch):
    from elasticdl_tpu_torch.parallel.spmd_trainer import SpmdTrainer

    loss = SpmdTrainer.global_loss
    monkeypatch.setattr(SpmdTrainer, "global_loss",
                        lambda self, x: loss(self, x) * (1 + 1e-6))
    with _counting(1) as flash, pytest.raises(
            SystemExit, match="mesh losses bit-equal"):
        chip_smoke.moe_phase(torch, np, flash, str(tmp_path), device="cpu",
                             **SMALL)


def test_moe_phase_fails_on_a_wrong_launch_count(tmp_path):
    with _counting(2) as flash, pytest.raises(SystemExit,
                                              match="K4-K6 2 a step"):
        chip_smoke.moe_phase(torch, np, flash, str(tmp_path), device="cpu",
                             **SMALL)


def test_moe_phase_fails_on_a_compact_combine_off(tmp_path, monkeypatch):
    from elasticdl_tpu_torch.models import moe_transformer

    combine = moe_transformer.moe_combine_compact
    monkeypatch.setattr(
        moe_transformer, "moe_combine_compact",
        lambda *args, **kwargs: combine(*args, **kwargs) * 1.01)
    with _counting(1) as flash, pytest.raises(
            SystemExit, match="compact against onehot"):
        chip_smoke.moe_phase(torch, np, flash, str(tmp_path), device="cpu",
                             **SMALL)


def test_moe_formulas_at_bench_shape():
    """scripts/bench_moe.py's counts at bench.py's MoE: 20.95 TFLOP a
    step with the one-hot dispatch, 18.89 without its einsums (the
    compact path), the dense arm at MLP ratio 7 18.89; 320 slots an
    expert."""
    args = (1024, 8, 1024, 16, 32000, 4, 8, 2, 1.25)
    assert round(chip_smoke.moe_flops(*args, False) / 1e12, 2) == 20.95
    assert round(chip_smoke.moe_flops(*args, True) / 1e12, 2) == 18.89
    assert chip_smoke.matched_mlp_ratio(4, 2, 1.25) == 7
    assert round(chip_smoke.model_train_flops(
        1024, 8, 1024, 16, 32000, 7) / 1e12, 2) == 18.89
    assert port_moe.expert_capacity(1024, 8, 2, 1.25) == 320


@pytest.mark.parametrize("kernel,want_ms,by", [
    ("fwd", 0.0402, "bytes"),
    ("dq", 0.0522, "operations"),
    ("dkv", 0.0696, "operations"),
])
def test_flash_bounds_at_the_moe_shape(kernel, want_ms, by):
    """The bounds PERF.md states at bench.py's MoE attention shape (B*H
    128, S 1024, d 128, bf16, causal), the kernel case
    ``moe_bf16_d128_causal``."""
    assert ("moe_bf16_d128_causal", 128, 1024, 128, "bfloat16",
            True) in chip_smoke.CASES
    ms, bound_by = chip_smoke.bound(128, 1024, 128, "bfloat16", True, kernel)
    assert round(ms, 4) == want_ms and bound_by == by


def test_fleet_replica_timeout_covers_a_stalled_heartbeat():
    """The card run's replica timeout: two heartbeat periods and one
    heartbeat RPC deadline (serve/main.py's 5 s), and a second."""
    env = chip_smoke.FLEET_ENV
    assert float(env["EDL_ROUTER_HEARTBEAT_SECS"]) == 1
    assert float(env["EDL_ROUTER_REPLICA_TIMEOUT_SECS"]) == 8
