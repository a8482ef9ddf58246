"""What every measurement names: the device JAX runs on and the card's
name and power limit (a card set below its maximum power runs slower
under load, so numbers are only comparable with the limit beside them)."""

from __future__ import annotations

import shutil
import subprocess

import jax

__all__ = ["device_record", "card_name_and_power"]


def device_record() -> dict:
    """The device as JAX reports it."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line;
    raises when there is no ``nvidia-smi``."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found: no NVIDIA card here")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
