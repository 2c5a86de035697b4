"""The card a run measures on: its name, count and power limit.

A run without the cards its cell asks for stops before it measures
anything (:class:`NoCard`); nothing falls back to the CPU."""

from __future__ import annotations

import subprocess


class NoCard(RuntimeError):
    """No CUDA device, or fewer than the cell asks for."""


def card(chips: int) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    n = torch.cuda.device_count()
    if n < chips:
        raise NoCard(f"the cell asks for {chips} CUDA devices and {n} are present")
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=int(chips),
                power_limit_w=power_limit())


def power_limit(index: int = 0):
    """The card's power limit in W as ``nvidia-smi`` reads it, or None."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i", str(index)],
                           capture_output=True, text=True, timeout=30, check=True)
        return float(r.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def label(info: dict) -> str:
    p = info.get("power_limit_w")
    return (f"{info['kind']} x{info['count']}, power limit "
            + (f"{p:.2f} W" if p is not None else "not read"))
