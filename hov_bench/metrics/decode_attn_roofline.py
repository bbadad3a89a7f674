"""decode_attn_roofline (kernels: B1, csrc/decode_attention.cu): the bound
of the decode attention the traced slice ran (each row's valid keys read
once, QK and PV over them) over the device time of its kernel."""

from hov_bench.core.readers import roofline

PATTERNS = ("decode_attn_kernel",)


def read(run):
    return roofline(run, "decode_attn", PATTERNS)
