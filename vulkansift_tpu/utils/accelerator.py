"""What the measurement entry points know about the card they run on.

``chip_smoke.py`` and ``bench.py`` refuse to run anywhere but a GPU (a
silent fall-back to the CPU would print CPU numbers under device names) and
stamp every result with the card's identity and power limit, because a card
set below its maximum power runs slower under load.
"""

from __future__ import annotations

import subprocess
from typing import Dict, Sequence

NVIDIA_SMI_QUERY = ("nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader")


def card_name_and_power() -> str:
    """``name, power.limit`` of every visible card, one line each, as
    ``nvidia-smi`` prints them. Runs in a child process that never imports
    JAX; raises if ``nvidia-smi`` is missing or fails."""
    out = subprocess.run(NVIDIA_SMI_QUERY, check=True, capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()


def require_gpu(devices: Sequence) -> None:
    """Raise unless JAX's first device is a GPU."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        raise RuntimeError(
            f"a GPU is required, but JAX's first device is {found!r}")


def device_record(devices: Sequence) -> Dict:
    """The device fields every result line carries."""
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}
