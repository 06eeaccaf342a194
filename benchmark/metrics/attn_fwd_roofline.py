"""attn_fwd_roofline: for every call of the attention forward op in the
traced window, the least time the card could take (max of its bytes over
the HBM rate and its FLOPs over the dense peak, from the op's recorded
input shapes), over the device time of the kernels the profiler attributes
to those calls, as a share (%)."""

from benchmark.flops import attention_roofline


def read(run):
    return attention_roofline(run)
