"""Multi-sequence batching: B sequences of one length through the odometry
front end on one device.

Port of ``randt_slam_tpu/parallel/batch.py`` without its mesh (one device):
the JAX package runs ``lax.scan(vmap(frontend_step))`` over a (B, T, ...)
frame batch, BASELINE configs 4-5 ("all 8 Oxford eval sequences batched in
parallel").  Here :func:`frontend_step` itself takes the batch axis: every
tensor of the carry and the frame has a leading (B,), and each device
operation of a frame, the kernels K1, K2, K3a/K3b and K4 included, covers
all B sequences at once.  So a batched frame makes the launches of one
sequence, and B sequences share the host's dispatch.  SLAM is sequential in
time: per-sequence latency is fixed, and fleet throughput scales with the
batch.

No ScanContext descriptor is made (``with_descriptor=False``): a fleet
throughput batch runs no loop pass per step, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import runtime
from ..config import SlamConfig
from ..pipeline import frontend as F
from ..pipeline import slam
from ..pipeline.frontend import init_batched_carry

__all__ = ["init_batched_carry", "make_batched_scan"]


def make_batched_scan(cfg: SlamConfig, sensor_to_base, device=None):
    """Returns ``scan_fn(carries, frames, on_frame=None) -> (carries, outs)``
    over a (B, T, ...) frame batch on ``device`` (CUDA unless
    ``device="cpu"``): ``carries`` from :func:`init_batched_carry`,
    ``frames`` a ``Frame`` of (B, T, ...) tensors (moved to the device
    once), ``outs`` a ``FrameOutput`` of numpy (B, T, ...) arrays.  The
    carries passed in are updated in place (the submap store) and must not
    be used again.  ``on_frame(t, carries)`` is called as in
    ``pipeline/slam.run_odometry``: before frame ``t`` is stepped."""
    dev = runtime.resolve_device(device)
    s2b = torch.as_tensor(np.asarray(sensor_to_base, np.float32)).to(dev)

    def scan_fn(carries: F.FrontendCarry, frames: F.Frame, on_frame=None):
        frames = F.Frame(*(x.to(dev) for x in frames))
        outs = []
        for t in range(frames.stamp.shape[1]):
            if on_frame is not None:
                on_frame(t, carries)
            fr = F.Frame(*(x[:, t] for x in frames))
            carries, out = F.frontend_step(cfg, carries, fr, s2b,
                                           with_descriptor=False)
            outs.append(out)
        return carries, slam.stack_outputs(outs, batch=frames.stamp.shape[0])

    return scan_fn
