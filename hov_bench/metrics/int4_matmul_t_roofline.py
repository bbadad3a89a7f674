"""int4_matmul_t_roofline (kernels: B7b, csrc/int4_transpose.cu): the bound
of the backward's dx = dy @ W^T over the frozen int4 weights in the traced
slice over the device time of its kernel."""

from hov_bench.core.readers import roofline

PATTERNS = ("transpose_kernel",)


def read(run):
    return roofline(run, "int4_matmul_t", PATTERNS)
