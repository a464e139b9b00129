"""What a measurement runs on: the device as JAX reports it, and the card's
name and power limit as ``nvidia-smi`` reports them.

A card may be set below its maximum power limit and then runs slower under
load, so every number a benchmark prints goes out beside this description.
Measurement scripts refuse to run without a GPU instead of falling back to
the CPU: a CPU time is not a device time.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Dict


class NoGPUError(RuntimeError):
    """JAX found no GPU, so there is nothing to measure."""


def require_gpu() -> Dict:
    """``{"platform", "kind", "count"}`` of JAX's devices; raises
    :class:`NoGPUError` unless the default device is a GPU."""
    import jax

    devs = jax.devices()
    info = {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
    if info["platform"] != "gpu":
        raise NoGPUError(f"no GPU: JAX's default device is {devs[0]!r}")
    return info


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` output, one line per
    card ("not available" where nvidia-smi is missing)."""
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not available"
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        timeout=30,
    )
    return out.stdout.strip() or out.stderr.strip()
