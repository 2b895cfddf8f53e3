"""The biased window-attention kernels' share of their roofline: the least
time of every block's biased forward and backward of a training step
(``costs/swinv2.py::window_attention_bound_s``) over the device time of
the three kernels that do that work in the traced stretch: the forward,
the backward's dq / dk / dv kernel and its dbias kernel."""

from portbench.costs import swinv2
from portbench.metrics import readers

#: the biased short-sequence kernels of ``deeplearning4j_tpu_torch/csrc``
#: by name
KERNELS = r"\battention_bias_(fwd|bwd|dbias)_kernel\b"


def read(ctx):
    p = ctx.peak
    if p is None:
        return None
    bound = swinv2.window_attention_bound_s(ctx.config, ctx.traffic,
                                            p["bf16_dense_flops_per_s"],
                                            p["hbm_bytes_per_s"])
    return readers.roofline(ctx, bound, KERNELS)
