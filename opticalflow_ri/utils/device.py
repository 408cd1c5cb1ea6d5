"""The accelerator a run is on, named in every record a measurement prints."""

from __future__ import annotations

import shutil
import subprocess


def nvidia_smi() -> str | None:
    """Name and power limit of each card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (one card per line); None where nvidia-smi is absent or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def device_record() -> dict:
    """Platform, device kind and count as JAX reports them, plus the
    nvidia-smi line."""
    import jax

    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "nvidia_smi": nvidia_smi(),
    }


def require_gpu() -> dict:
    """``device_record()`` of the default backend; exits non-zero when it is
    not a GPU, so a measurement never times another device by accident."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default device is {rec['platform']} "
            f"({rec['kind']}); this measurement runs on a GPU only")
    return rec
