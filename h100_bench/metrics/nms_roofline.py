"""% of its roofline that the NMS kernel (`csrc/nms.cu`) reaches: the
benchmark's byte bound of the pairs traced over the kernel's device time
in the trace. Bound by bytes: each tile's score map read and written
once at 3.35 TB/s."""

from h100_bench.readers import nms_bound_s, roofline


def read(run):
    return roofline(run, "nms_border_kernel", nms_bound_s(run))
