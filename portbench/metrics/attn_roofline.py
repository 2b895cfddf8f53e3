"""The attention kernels' share of their roofline: the least time of
every layer's forward, dq and dk/dv kernel of a training step
(``costs/gpt2.py::attention_bound_s``) over their device time in the
traced stretch."""

from portbench.costs import gpt2
from portbench.metrics import readers

#: the attention kernels (forward, dq, dk/dv) of
#: ``deeplearning4j_tpu_torch/csrc`` by name
KERNELS = r"\b(attention_(wide_)?(fwd|bwd|dq|dkv)_kernel|" \
    r"flash_(fwd|dq|dkv)_f32_kernel)\b"


def read(ctx):
    p = ctx.peak
    if p is None:
        return None
    bound = gpt2.attention_bound_s(ctx.config, ctx.traffic,
                                   p["bf16_dense_flops_per_s"],
                                   p["hbm_bytes_per_s"])
    return readers.roofline(ctx, bound, KERNELS)
