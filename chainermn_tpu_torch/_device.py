"""Device resolution shared by the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: with no
CUDA device and no explicit ``device="cpu"`` they raise instead of
silently falling back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``; raises when
    it names CUDA and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run on the CPU"
        )
    return dev


def check_model_device(model_device: torch.device, device) -> torch.device:
    """Resolve ``device`` and check that a model lives there (``cuda``
    names any CUDA device; ``cuda:1`` that one).  Returns the model's
    device."""
    dev = resolve_device(device)
    if model_device.type != dev.type or (
            dev.index is not None and model_device.index != dev.index):
        raise ValueError(f"the model lives on {model_device}, not {dev}")
    return model_device
