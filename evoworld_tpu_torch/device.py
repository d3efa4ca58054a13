"""Device choice for the port's entry points: CUDA unless asked for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return the torch device an entry point runs on.

    A CUDA device raises `RuntimeError` when no card is present; there is no
    silent fallback to the CPU. Pass `device="cpu"` explicitly to run the
    plain versions of the kernels (as the tests do).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}")
    return dev
