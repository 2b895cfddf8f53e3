"""GPT-2 in the program: ``models/transformer.py::transformer_lm_conf`` at
the configuration file's sizes, trained by ``ComputationGraph.fit_batch``
in the file's compute dtype on float32 masters."""

from __future__ import annotations

from typing import Dict

from deeplearning4j_tpu_torch.models import transformer_lm_conf
from deeplearning4j_tpu_torch.nn.graph.vertices import LayerVertex


def conf(cfg: Dict):
    """The program's graph configuration for ``cfg``; raises where the
    program would run something other than the file states."""
    t = cfg["training"]
    if cfg["n_inner"] % cfg["n_embd"]:
        raise ValueError("n_inner must be a multiple of n_embd")
    run = cfg["departures"]
    if cfg["activation_function"] != "gelu_new" or \
            run["tie_word_embeddings"] or \
            any(run[k] for k in ("embd_pdrop", "attn_pdrop", "resid_pdrop")):
        raise ValueError("the program's LM is untied gelu(tanh) without "
                         "dropout")
    c = transformer_lm_conf(cfg["vocab_size"], d_model=cfg["n_embd"],
                            num_heads=cfg["n_head"],
                            num_layers=cfg["n_layer"],
                            ff_mult=cfg["n_inner"] // cfg["n_embd"],
                            max_length=cfg["n_positions"], drop_out=0.0,
                            learning_rate=t["learning_rate"])
    for v in c.vertices.values():
        if not isinstance(v, LayerVertex):
            continue
        layer = v.layer
        layer.updater = t["updater"]
        layer.adam_mean_decay = t["adam_beta1"]
        layer.adam_var_decay = t["adam_beta2"]
        layer.epsilon = t["adam_epsilon"]
        if hasattr(layer, "eps"):
            layer.eps = cfg["layer_norm_epsilon"]
    return c
