"""The device rule of the port: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; raise when there is none.

    The port never moves to the CPU on its own: a caller that wants the plain
    PyTorch versions on the CPU (the tests) passes ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
