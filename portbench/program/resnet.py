"""ResNet-50 in the program: ``models/resnet.py::resnet_conf`` at the
configuration file's sizes, trained by ``ComputationGraph.fit_batch`` in
the file's compute dtype on float32 masters, every batch norm on the
program's batch-norm kernels."""

from __future__ import annotations

from typing import Dict

from deeplearning4j_tpu_torch.models.resnet import resnet_conf
from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
from deeplearning4j_tpu_torch.nn.graph.vertices import LayerVertex


def conf(cfg: Dict):
    """The program's graph configuration for ``cfg``; raises where the
    program would run something other than the file states."""
    t = cfg["training"]
    if (cfg["stem_kernel"], cfg["stem_stride"]) != (7, 2):
        raise ValueError("the program's stem is a 7x7 / 2 convolution")
    c = resnet_conf(cfg["blocks"], [tuple(w) for w in cfg["widths"]],
                    cfg["num_classes"], cfg["height"], cfg["width"],
                    cfg["channels"], learning_rate=t["learning_rate"],
                    updater=t["updater"])
    for v in c.vertices.values():
        if not isinstance(v, LayerVertex):
            continue
        layer = v.layer
        layer.momentum = t["momentum"]
        layer.l2 = t["l2"]          # batch norm has no penalized leaf
        if isinstance(layer, BatchNormalization):
            layer.eps, layer.decay = cfg["bn_eps"], cfg["bn_decay"]
    return c
