"""int4_prefill_roofline.train (kernels: B5b, csrc/int4_prefill.cu): the
bound of the int4 products of 128 rows or more the traced slice ran (the
packed weight and its group scales read once, x read and y written once,
2 m din dout operations) over the device time of their kernel."""

from hov_bench.core.readers import roofline

PATTERNS = ("int4_prefill_kernel",)


def read(run):
    return roofline(run, "int4_prefill", PATTERNS)
