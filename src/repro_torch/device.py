"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card. There is
no silent CPU fallback: without CUDA, ``None`` raises, and the CPU runs only
when the caller names it (``device="cpu"``, as the tests do), in which case
each kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; anything else is taken as given.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or by
    default) and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
