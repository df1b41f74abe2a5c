"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`None` means the CUDA card. Without a card, only an explicit CPU
    request is honoured: the port never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "emloco_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def full_float32(dev: torch.device) -> None:
    """On a CUDA device, the networks' float32 GEMMs and convs in full
    float32, not TF32 (the physics step sets this for itself)."""
    if dev.type == "cuda":
        torch.backends.cuda.matmul.fp32_precision = "ieee"
        torch.backends.cudnn.conv.fp32_precision = "ieee"


def name(dev: torch.device) -> str:
    """The card's name, or "cpu"."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
