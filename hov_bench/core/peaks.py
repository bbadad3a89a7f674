"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates) and the
card's own power limit, which the rates assume at 700 W."""

from __future__ import annotations

import subprocess

BF16_FLOPS = 989e12  # the int4 and int8 weights run on the bf16 tensor cores
HBM_BYTES_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take for this work."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_S)


def power_limit_w():
    """`nvidia-smi`'s power.limit of card 0 in W, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None
