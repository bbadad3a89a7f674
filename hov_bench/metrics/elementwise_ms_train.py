"""elementwise_ms.train (train step: train/step.py, models/lora.py):
device ms a step of the traced slice in kernels that are neither the
library's matrix products nor the port's own kernels (the f32 adapters'
casts and sums, AdamW, norms, softmax, copies)."""

from hov_bench.core.readers import GEMM_KERNELS, PORT_KERNELS, kernel_ms_per


def pick(name: str) -> bool:
    if name.startswith(("Memcpy", "Memset")):
        return False
    return not any(p in name for p in GEMM_KERNELS + PORT_KERNELS)


def read(run):
    return kernel_ms_per(run, pick, "steps")
