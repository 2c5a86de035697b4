"""Radar NDT SLAM in PyTorch with hand-written CUDA kernels for Hopper.

The port of ``randt_slam_tpu`` (JAX/XLA/Pallas) module by module: the same
module names, the same fixed-shape tensors and ``NamedTuple`` carries, plain
PyTorch for the tensor code and CUDA C++ (``csrc/``) for every kernel that the
JAX package wrote in Pallas.  The JAX package stays the reference; this
package imports nothing of it.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no device given and no CUDA present they raise instead of dropping to the CPU.
"""

import torch as _torch

# Float32 everywhere, TF32 off: the counterpart of the JAX package pinning
# ``jax_default_matmul_precision=highest``.  The workload's contractions are
# small state-estimation products (SE(2) transforms of cell distributions,
# 3x3 whitening, window Jacobians) where reduced-precision rounding turns a
# 0.09 m odometry ATE into metres of drift.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from . import config, geometry  # noqa: E402,F401

__version__ = "0.1.0"
