"""mfu.train (device, the whole step): model FLOPs of the window's useful work
(hov_bench/core/work.py) over the window's seconds at the bf16 peak of
989 TFLOP/s (%), the card's power limit printed beside it."""

from hov_bench.core.readers import mfu


def read(run):
    return mfu(run)
