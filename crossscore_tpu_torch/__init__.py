"""CrossScore in PyTorch for NVIDIA Hopper (H100).

The counterpart of ``crossscore_tpu`` (JAX/Flax/Pallas on TPU). Module paths
and class names mirror the JAX package; the Pallas kernels of the predict
forward are hand-written CUDA C++ under ``csrc/`` (built with ``nvcc`` at first
use, bound with ``ctypes``). This package imports ``torch`` and numpy only.

Entry points run on CUDA unless the caller passes ``device="cpu"``; on a CPU
tensor every kernel wrapper takes its plain PyTorch version instead.
"""

from crossscore_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
