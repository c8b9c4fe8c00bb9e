"""The frozen arithmetic against hand counts."""

import pytest
import torch

from portbench import trace, yardstick


def test_gpt3_xl_parameters_and_flops():
    n = yardstick.lm_params(50257, 2048, 8192, 24)
    assert n == 50257 * 2048 + 24 * (4 * 2048**2 + 2 * 2048 * 8192
                                     + 4 * 2048) + 2 * 2048
    assert round(n / 1e9, 3) == 1.311
    f = yardstick.lm_train_flops(n, 8 * 2048, 8, 2048, 16, 128, 24)
    assert f == pytest.approx(1.39e14, rel=5e-3)
    f = yardstick.lm_train_flops(n, 16384, 1, 16384, 16, 128, 24)
    assert f == pytest.approx(2.08e14, rel=5e-3)


def test_resnet50_flops_per_training_image():
    f = yardstick.resnet_train_flops_per_image(torch, [3, 4, 6, 3], 64,
                                               1000, 224)
    assert f / 1e9 == pytest.approx(24.54, abs=0.005)


def test_flash_bounds_at_the_kernel_table_shapes():
    b = yardstick.flash_bound_s(64, 4096, 128)
    assert b["flash_fwd"] * 1e3 == pytest.approx(0.278, abs=5e-4)
    assert b["flash_dq"] * 1e3 == pytest.approx(0.417, abs=5e-4)
    assert b["flash_dkv"] * 1e3 == pytest.approx(0.556, abs=5e-4)
    w = yardstick.flash_work(64, 4096, 128)
    assert w["flash_fwd"][0] == pytest.approx(2.749e11, rel=1e-3)


def test_kernel_classes():
    assert yardstick.kernel_kind("void flash_fwd_wgmma<128>(...)") == "flash"
    assert yardstick.kernel_kind("ncclDevKernel_AllReduce") == "nccl"
    assert yardstick.kernel_kind("nvjet_tst_128x256") == "gemm"
    assert yardstick.kernel_kind("vectorized_elementwise_kernel") == "other"
    assert yardstick.resnet_kind("cudnn::bn_fw_tr_1C11") == "conv (cuDNN)"
    assert yardstick.resnet_kind("batch_norm_backward_kernel") == "batch-norm"
    assert yardstick.flash_kernel("void flash_dkv_wgmma<128>") == "flash_dkv"
    assert yardstick.flash_kernel("void flash_dq_simt<float>") == "flash_dq"
    assert yardstick.flash_kernel("gemm") is None


def test_interval_arithmetic():
    spans = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30)]
    assert trace.union(spans) == [[0, 15], [20, 30]]
    assert trace.length(trace.union(spans)) == 25
    assert trace.subtract([[0, 30]], [[0, 15], [20, 30]]) == 5
    assert trace.subtract([[0, 10], [12, 18]], [[5, 13]]) == 10
    st = {"kernels": [("k1", 0.0, 1e6), ("k2", 3e6, 4e6)],
          "host": [("aten::item", 0.5e6, 3.5e6), ("outer", 0, 5e6)],
          "wall_s": 5.0, "steps": 1}
    assert trace.busy_s(st) == 2.0
    bd = trace.breakdown(st)
    assert bd["device_ops"] == [["k1", 1.0], ["k2", 1.0]]
    assert bd["idle_gaps"] == [["aten::item", 2.0]]
