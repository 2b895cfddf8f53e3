"""SwinV2 in the program: ``models/swin.py::swinv2_conf`` at the
configuration file's sizes, trained by ``ComputationGraph.fit_batch`` in
the file's compute dtype on float32 masters, every window attention on
the program's biased short-sequence kernels."""

from __future__ import annotations

from typing import Dict

from deeplearning4j_tpu_torch.models.swin import swinv2_conf
from deeplearning4j_tpu_torch.nn.graph.vertices import LayerVertex


def conf(cfg: Dict):
    """The program's graph configuration for ``cfg``; raises where the
    program would run something other than the file states."""
    t = cfg["training"]
    run = cfg["departures"]
    if run["drop_path_rate"]["run"] or run["clip_grad"]["run"] or \
            cfg["pretrained_window_size"]:
        raise ValueError("the program's SwinV2 trains without stochastic "
                         "depth or gradient clipping, from no pretrained "
                         "window")
    c = swinv2_conf(cfg["num_classes"], cfg["image_size"], cfg["patch_size"],
                    cfg["embed_dim"], cfg["depths"], cfg["num_heads"],
                    cfg["window_size"], cfg["mlp_ratio"], cfg["cpb_hidden"],
                    cfg["ln_eps"], cfg["logit_scale_max"],
                    cfg["mask_value"], cfg["channels"],
                    learning_rate=t["learning_rate"], updater=t["updater"])
    for v in c.vertices.values():
        if isinstance(v, LayerVertex):
            v.layer.adam_mean_decay = t["adam_beta1"]
            v.layer.adam_var_decay = t["adam_beta2"]
            v.layer.epsilon = t["adam_epsilon"]
    return c
