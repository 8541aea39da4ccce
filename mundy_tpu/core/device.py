"""Device identity for measurement scripts (bench.py, chip_smoke.py).

A measurement names the device it ran on and refuses to run without a GPU:
a CPU fallback would report host numbers under a device metric's name.
"""

from __future__ import annotations

import subprocess

import jax


def nvidia_smi(query: str = "name,power.limit") -> str:
    """`nvidia-smi --query-gpu=<query> --format=csv,noheader` output (one
    line per card); run as a child process that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip()


def require_gpu() -> dict:
    """{'platform', 'kind', 'count'} of the default devices; raises
    RuntimeError unless they are GPUs."""
    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"needs a GPU; JAX found {info['count']} {info['platform']} "
            "device(s)")
    return info
