"""The benchmark's frozen arithmetic: peaks, kernel classes, work counts.

Every function here is a copy taken once from ``chip_smoke.py`` (the
port's smoke script) and frozen, so that a later change to that script
or to the program cannot move the yardstick.  Each one names what it was
copied from.  Nothing here imports the program.
"""

from __future__ import annotations

# Published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet):
# bf16 tensor-core FLOP/s and HBM3 bytes/s.
# Copied from chip_smoke.py: PEAK_BF16_FLOPS, PEAK_HBM_BYTES.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def kernel_kind(name: str) -> str:
    """Kind of a kernel of the LM step, from its name.
    Copied from chip_smoke.py: kernel_kind."""
    low = name.lower()
    return ("flash" if "flash_" in low else
            "nccl" if "nccl" in low else
            "gemm" if any(w in low for w in ("gemm", "nvjet", "xmma",
                                              "cutlass", "cublas")) else
            "other")


def resnet_kind(name: str) -> str:
    """Kind of a kernel of the convnet steps, from its name.
    Copied from chip_smoke.py: resnet_kind."""
    low = name.lower()
    for kind, words in (
            ("nccl", ("nccl",)),
            ("copy", ("memcpy", "memset", "copy", "nchwtonhwc", "nhwctonchw")),
            ("conv (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "cudnn")),
            ("batch-norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
            ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
            ("optimizer", ("multi_tensor_apply", "foreach")),
            ("pooling", ("pool",)),
            ("reduction", ("reduce",))):
        if any(w in low for w in words):
            return kind
    return "elementwise"


def flash_kernel(name: str):
    """Which of the three flash kernels a device kernel's name is
    (``flash_fwd``, ``flash_dq``, ``flash_dkv``), else ``None``."""
    low = name.lower()
    for k in ("flash_fwd", "flash_dq", "flash_dkv"):
        if k in low:
            return k
    return None


def flash_work(BH: int, S: int, D: int, causal: bool = True) -> dict:
    """FLOP and bytes of one launch of each flash kernel over ``(BH, S,
    D)`` bf16 q/k/v/dO: the live (q, k) pairs (causal: S(S+1)/2 a row of
    BH), each input byte read once and each output byte written once.
    Copied from chip_smoke.py: phase_time's ``work``."""
    pairs = (S * (S + 1) // 2 if causal else S * S) * BH
    el = BH * S * D * 2                        # one bf16 operand, bytes
    row = BH * S * 4                           # one fp32 row statistic
    return {
        "flash_fwd": (4 * D * pairs, 4 * el + row),
        "flash_dq": (6 * D * pairs, 5 * el + 2 * row),
        "flash_dkv": (8 * D * pairs, 6 * el + 2 * row),
    }


def flash_bound_s(BH: int, S: int, D: int, causal: bool = True) -> dict:
    """The least time of one launch of each kernel on the card:
    max(FLOP / bf16 peak, bytes / HBM peak), in seconds.
    Copied from chip_smoke.py: phase_time's ``bound_ms``."""
    return {k: max(f / PEAK_BF16_FLOPS, b / PEAK_HBM_BYTES)
            for k, (f, b) in flash_work(BH, S, D, causal).items()}


def lm_params(vocab: int, d_model: int, d_ff: int, n_layers: int) -> int:
    """Parameters of the decoder-only LM as configured: a tied (V, D)
    embedding; per layer q, k, v, o (D x D, no bias), the two
    feed-forward matrices (D x F, no bias) and two LayerNorms (scale and
    shift); a final LayerNorm."""
    layer = 4 * d_model * d_model + 2 * d_model * d_ff + 4 * d_model
    return vocab * d_model + n_layers * layer + 2 * d_model


def lm_train_flops(n_params: int, tokens: int, batch: int, seq: int,
                   n_heads: int, d_head: int, n_layers: int) -> float:
    """Model FLOPs of one training step: 6 N T for the weights, plus 3 x
    the causal attention's forward (4 d_head FLOP a live (q, k) pair: q
    k^T and p v) in every layer.  Recomputation is not counted."""
    pairs = seq * (seq + 1) // 2 * batch * n_heads
    return 6.0 * n_params * tokens + 3.0 * 4 * d_head * pairs * n_layers


def forward_macs(torch, model, image: int, classes) -> int:
    """Multiply-adds of one image's forward, from the conv and dense
    shapes: a hook on each layer of ``classes``, one forward of a batch of
    one on the meta device.
    Copied from chip_smoke.py: forward_macs (there over the program's
    layers on the card; here over the reference's, on the meta device)."""
    macs = [0]

    def hook(mod, inputs, out):
        macs[0] += out.numel() * mod.weight[0].numel()

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, classes)]
    try:
        with torch.no_grad():
            model(torch.zeros(1, image, image, 3, device="meta"))
    finally:
        for h in handles:
            h.remove()
    return macs[0]


def resnet_train_flops_per_image(torch, stage_sizes, num_filters, classes,
                                 image) -> float:
    """3 x 2 x the forward multiply-adds of one image (forward, and a
    backward of twice the forward), as chip_smoke.py's phase 7a counts."""
    from .reference.resnet import RefConv, RefDense, RefResNet

    with torch.device("meta"):
        model = RefResNet(stage_sizes, num_filters, classes)
    return 3 * 2 * forward_macs(torch, model, image, (RefConv, RefDense))
