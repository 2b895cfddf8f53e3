"""The batch-norm kernels' share of their roofline: the least bytes of
every batch norm of a step (``costs/resnet.py::bn_bytes``) at the card's
memory bandwidth, over their device time in the traced stretch."""

from portbench.costs import resnet
from portbench.metrics import readers

#: the batch-norm kernels (``csrc/batchnorm.cu``'s namespaces)
KERNELS = r"\bdl4j_bn(_gen)?::"


def read(ctx):
    p = ctx.peak
    if p is None:
        return None
    bound = resnet.bn_bytes(ctx.config, ctx.traffic["batch"]) / \
        p["hbm_bytes_per_s"]
    return readers.roofline(ctx, bound, KERNELS)
