"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel package holds ``ops.py`` (the wrapper: checks, allocation,
launch, launch count) and ``ref.py`` (the plain version).  A wrapper given
CPU tensors runs the plain version; given CUDA tensors it launches the
kernel or raises.  The kernels are compiled from ``repro_torch/csrc`` with
``nvcc`` at first use (``_lib.build``), never at import.
"""
from repro_torch.kernels._lib import LAUNCHES, build, reset_launches

__all__ = ["LAUNCHES", "build", "reset_launches"]
