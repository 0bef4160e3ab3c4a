"""% of its roofline that the attention kernel (`csrc/attention.cu`)
reaches: the benchmark's bound of every attention call of the pairs
traced (the larger of operations at 989 TFLOP/s and bytes at 3.35 TB/s,
a call at a time; operations bound every call at these sizes) over the
kernel's device time in the trace."""

from h100_bench.readers import attention_bound_s, roofline


def read(run):
    return roofline(run, "masked_attention_kernel", attention_bound_s(run))
