"""What the per-layer metric readers share. A reader that finds nothing to
read returns None, and the run leaves its metric out."""

from __future__ import annotations

from typing import Optional, Sequence

from hov_bench.core.peaks import BF16_FLOPS, bound_s

# the port's own kernels: every `__global__` function in handsonvlm_torch/csrc
PORT_KERNELS = ("decode_attn_kernel", "flash_bwd_delta_kernel", "flash_bwd_dkv_fma_kernel",
                "flash_bwd_dq_fma_kernel", "flash_bwd_wgmma_kernel", "flash_fwd_fma_kernel",
                "flash_fwd_wgmma_kernel", "fused_mlp_down_kernel", "fused_mlp_gate_up_kernel",
                "fwd_merge_kernel", "gather_blocks_kernel", "gemv_kernel", "int4_prefill_kernel",
                "int8_split_merge_kernel", "int8_tc_kernel", "merge_splits_kernel",
                "pack_frags_kernel", "split_rows_kernel", "to_bf16_kernel", "transpose_kernel",
                "vit_attn_fma_kernel", "vit_attn_mma_kernel")
# the library's matrix products (cuBLAS / cuBLASLt kernel names on Hopper)
GEMM_KERNELS = ("gemm", "nvjet", "cutlass", "xmma", "cublas", "Kernel2", "splitKreduce")


def roofline(run, key: str, patterns: Sequence[str]) -> Optional[float]:
    """Share (%) of the bound of the work recorded under `key` during the
    traced slice (entries (calls, flops, bytes)) over the device time of
    the kernels whose names hold `patterns` in that slice."""
    s = run.slice.summary
    entries = run.work.get(key)
    if not on_card(run) or s is None or not entries:
        return None
    ks = s.kernels(patterns)
    spent = sum(b - a for _, a, b in ks)
    if spent <= 0:
        return None
    run.info[f"{key}_launches"] = [len(ks), sum(n for n, _, _ in entries)]
    return 100.0 * sum(n * bound_s(f, b) for n, f, b in entries) / spent


def on_card(run) -> bool:
    """Device metrics are read from card runs only."""
    return run.device.type == "cuda"


def idle_pct(run) -> Optional[float]:
    s = run.slice.summary
    if not on_card(run) or s is None or s.window_s <= 0 or not s.device_ops:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def mfu(run) -> Optional[float]:
    """Model FLOPs of the window's useful work over the window's seconds
    at the bf16 peak (%)."""
    if not on_card(run):
        return None
    flops = run.counters.get("flops")
    seconds = run.counters.get("flops_seconds", run.seconds)
    if not flops or seconds <= 0:
        return None
    return 100.0 * flops / (seconds * BF16_FLOPS)


def kernel_ms_per(run, pick, per: str) -> Optional[float]:
    """Device ms of the traced kernels that `pick(name)` accepts, per unit
    of the counter `slice_<per>` (the units the slice holds)."""
    s = run.slice.summary
    n = run.counters.get(f"slice_{per}")
    if not on_card(run) or s is None or not n:
        return None
    return 1e3 * sum(b - a for name, a, b in s.device_ops if pick(name)) / n
