"""Device resolution for the port's entry points.

The port runs on an NVIDIA GPU. ``device=None`` means ``"cuda"``; a caller
who wants the CPU (the tests) asks for it by name. There is no silent
fallback: a missing card raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if the requested CUDA device is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nf_tpu_torch runs on an NVIDIA GPU by default and CUDA is not "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
