"""% of its roofline that ALIKED-n16's four deformable convolutions
reach: the benchmark's bound of a pair's (each convolution's larger of
its offset convolution's and its 3x3 product's FLOPs at 989 TFLOP/s and
its input read, its offsets and its output written once at 3.35 TB/s;
`aliked_flops.py`, whatever implements them) over `aliked_dcn_s`, the
program's span of them. A span and not the device trace: the
convolutions run PyTorch's generic kernels, which the trace cannot tell
apart by name. Nothing where the program records no such span."""

from h100_bench.aliked_flops import dcn_pair_bound_s
from h100_bench.readers import stage_mean


def read(run):
    t = stage_mean(run, "aliked_dcn")
    if not t:
        return None
    return 100.0 * dcn_pair_bound_s(run) / t
