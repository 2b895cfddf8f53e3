"""SwinV2 as a ComputationGraph (Liu et al., "Swin Transformer V2: Scaling
Up Capacity and Resolution", arXiv:2111.09883; the layer equations of the
public ``swinv2_base_patch4_window16_256`` configuration of
github.com/microsoft/Swin-Transformer), on NHWC images:

- ``patch_embed``: a ``patch_size`` x ``patch_size`` / ``patch_size``
  convolution with a bias (3 → ``embed_dim``), then ``patch_norm``
  (LayerNorm over the channels);
- stage i: ``depths[i]`` :class:`SwinV2Block` s ``s{i}b{j}`` of
  ``num_heads[i]`` heads at width ``embed_dim · 2^i``, the odd ones
  shifted by ``window_size / 2`` (no shift, and the window clipped, where
  the stage's resolution is at most the window); after every stage but
  the last a :class:`PatchMerging` ``s{i}_merge`` (2 x 2 → 4C → 2C, then
  LayerNorm);
- ``head_norm`` (LayerNorm), ``pool`` (the mean over the tokens) and
  ``fc``, a softmax head scored by cross-entropy.

LayerNorms take eps ``ln_eps``; the MLPs are ``mlp_ratio`` x wide with the
exact (erf) GELU. Stochastic depth and dropout are left out: the port
trains the function without them. ``swinv2_conf()`` is SwinV2-B at 256²
with window 16."""

from __future__ import annotations

import math
from typing import Sequence

from ..nn.conf.config import NeuralNetConfiguration
from ..nn.conf.input_type import InputType
from ..nn.conf.layers import (ChannelLayerNorm, ConvolutionLayer,
                              GlobalPoolingLayer, OutputLayer, PatchMerging,
                              SwinV2Block)
from ..nn.graph.graph_config import ComputationGraphConfiguration


def swinv2_conf(num_classes: int = 1000, image_size: int = 256,
                patch_size: int = 4, embed_dim: int = 128,
                depths: Sequence[int] = (2, 2, 18, 2),
                num_heads: Sequence[int] = (4, 8, 16, 32),
                window_size: int = 16, mlp_ratio: int = 4,
                cpb_hidden: int = 512, ln_eps: float = 1e-5,
                logit_scale_max: float = math.log(100.0),
                mask_value: float = -100.0, channels: int = 3,
                learning_rate: float = 1e-3, updater: str = "adam",
                seed: int = 123) -> ComputationGraphConfiguration:
    """A SwinV2 image classifier on [N, image_size, image_size, channels]
    inputs (defaults: SwinV2-B, 256², window 16)."""
    if len(depths) != len(num_heads):
        raise ValueError("depths and num_heads need one entry a stage")
    g = (NeuralNetConfiguration.Builder()
         .seed(seed).learning_rate(learning_rate).updater(updater)
         .weight_init("xavier")
         .graph_builder()
         .add_inputs("input"))
    g.add_layer("patch_embed",
                ConvolutionLayer(n_out=embed_dim,
                                 kernel_size=[patch_size, patch_size],
                                 stride=[patch_size, patch_size],
                                 has_bias=True, activation="identity"),
                "input")
    g.add_layer("patch_norm", ChannelLayerNorm(eps=ln_eps), "patch_embed")
    x = "patch_norm"
    for i, (depth, heads) in enumerate(zip(depths, num_heads)):
        for j in range(depth):
            g.add_layer(f"s{i}b{j}",
                        SwinV2Block(num_heads=heads, window_size=window_size,
                                    shift_size=window_size // 2 if j % 2
                                    else 0,
                                    mlp_ratio=mlp_ratio,
                                    cpb_hidden=cpb_hidden,
                                    logit_scale_max=logit_scale_max,
                                    mask_value=mask_value, eps=ln_eps), x)
            x = f"s{i}b{j}"
        if i < len(depths) - 1:
            g.add_layer(f"s{i}_merge", PatchMerging(eps=ln_eps), x)
            x = f"s{i}_merge"
    g.add_layer("head_norm", ChannelLayerNorm(eps=ln_eps), x)
    g.add_layer("pool", GlobalPoolingLayer(pooling_type="avg"), "head_norm")
    g.add_layer("fc", OutputLayer(n_out=num_classes, loss="mcxent",
                                  activation="softmax"), "pool")
    return (g.set_outputs("fc")
            .set_input_types(InputType.convolutional(image_size, image_size,
                                                     channels))
            .build())
