"""Hand-written CUDA kernels and their plain PyTorch versions."""

from .build import LAUNCHES, reset_launches  # noqa: F401
