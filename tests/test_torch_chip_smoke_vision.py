"""chip_smoke.py's phase 15 (the vision zoo and the rest of the dense
step), rehearsed on the CPU at small sizes: bench.py's ResNet-50
configuration at 32x32, batch 2; the agreement check CPU against CPU;
ResNet-50 (8 filters) as a job with a ``worker.main`` process and a
``serve.main`` process answering from its export; the TransformerLM's
remat policies at 2 layers, d 128, with K4-K6 counted by wrapping their
plain versions (the CPU path counts no launch); the small zoo models'
LocalExecutor runs. What only the card can give (times, peak memory,
the profile) reads "not measured" here.
"""

import os

import pytest

import chip_smoke


@pytest.fixture
def counted_flash():
    """Bump the wrappers' launch counters on the CPU, as the CUDA path
    does at each launch."""
    from elasticdl_tpu_torch.ops import flash_attention as flash

    fwd, bwd = flash.flash_attention_fwd, flash.flash_attention_bwd

    def counted_fwd(*args, **kwargs):
        flash.LAUNCHES += 1
        return fwd(*args, **kwargs)

    def counted_bwd(*args, **kwargs):
        flash.DQ_LAUNCHES += 1
        flash.DKV_LAUNCHES += 1
        return bwd(*args, **kwargs)

    flash.flash_attention_fwd = counted_fwd
    flash.flash_attention_bwd = counted_bwd
    try:
        yield flash
    finally:
        flash.flash_attention_fwd, flash.flash_attention_bwd = fwd, bwd


def test_resnet_bench_and_agreement_rehearse():
    import numpy as np
    import torch

    torch.set_num_threads(1)
    record = chip_smoke.resnet_bench(torch, np, device="cpu", batch=2,
                                     image=32, classes=10, warmup=1,
                                     windows=1, window_steps=1)
    assert record["images_per_s"] > 0 and len(record["losses"]) == 2
    assert record["model_tflop_per_step"] > 0
    agreement = chip_smoke.resnet_agreement(torch, np, device="cpu",
                                            batch=2, image=32, classes=10)
    assert agreement["loss_rel_diff"] == 0.0


def test_conv_dense_flops_counts_products():
    import torch

    from elasticdl_tpu_torch.models import resnet

    model = resnet.resnet50(num_classes=1000, stem="space_to_depth")
    flops = chip_smoke.conv_dense_flops(torch, model,
                                        torch.zeros(1, 224, 224, 3))
    # ResNet-50's ~4.1 GMAC a 224x224 image, as 2 FLOPs a MAC
    assert 7.5e9 < flops < 8.8e9


def test_vision_job_rehearses(tmp_path):
    """The job, its export with batch_stats and the served answers."""
    import numpy as np
    import torch

    torch.set_num_threads(1)
    out = chip_smoke.vision_job(
        torch, np, str(tmp_path), device="cpu", records=32, image=32,
        classes=4, batch=8, per_task=16, model_params="num_filters=8",
        requests=4, compute_dtype="")
    assert out["master_rc"] == 0 and out["worker_rc"] == 0
    assert out["tasks"] == 2 and out["export_step"] == 4
    assert out["export_batch_stats_arrays"] > 0
    assert out["serve"]["max_abs"] <= chip_smoke.SERVE_MAX_TOL


def test_remat_phase_rehearses(counted_flash):
    import numpy as np
    import torch

    torch.set_num_threads(1)
    out = chip_smoke.remat_phase(
        torch, np, counted_flash, device="cpu",
        widths=dict(vocab_size=256, num_layers=2, num_heads=2,
                    embed_dim=128), seq=64, batch=2, long_seq=128, steps=1)
    assert out["launches"] == {
        "none": {"fwd": 2, "dq": 2, "dkv": 2},
        "dots": {"fwd": 2, "dq": 2, "dkv": 2},
        "flash": {"fwd": 2, "dq": 2, "dkv": 2},
        "full": {"fwd": 4, "dq": 2, "dkv": 2}}
    for record in out["policies"][1:]:
        assert record["grad_leaves_outside_tol"] == 0
    assert out["dropout"]["param_max_abs_diff"] <= chip_smoke.REMAT_GRAD_ATOL


def test_small_zoo_phase_rehearses(tmp_path):
    import numpy as np
    import torch

    torch.set_num_threads(1)
    out = chip_smoke.small_zoo_phase(torch, np, str(tmp_path), device="cpu",
                                     records=192, batch=32)
    assert set(out) >= {"mnist", "cifar10", "mobilenet"}
    assert all(out[name]["steps"] == 6 for name in ("mnist", "cifar10"))


def test_vision_images_plant_the_class():
    import numpy as np

    images, labels = chip_smoke.vision_images(
        np, np.random.default_rng(0), 64, 16, 4)
    assert images.dtype == np.uint8 and images.shape == (64, 16, 16, 3)
    for image, label in zip(images, labels):
        row, col = divmod(int(label), 2)
        quadrant = image[row * 8:(row + 1) * 8, col * 8:(col + 1) * 8, 0]
        assert quadrant.mean() > 150
    assert os.path.basename(chip_smoke.__file__) == "chip_smoke.py"
