"""Decoder-only transformer language model (the JAX package's
``models/transformer.py``): TokenAndPositionEmbedding → pre-LN blocks
(LayerNormalization → causal SelfAttentionLayer → residual add →
LayerNormalization → TransformerFeedForward → residual add) → final LN →
RnnOutputLayer. The configuration JSON is identical to the JAX package's
for the same arguments."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..nn.conf.config import NeuralNetConfiguration
from ..nn.conf.layers import (LayerNormalization, RnnOutputLayer,
                              SelfAttentionLayer, TokenAndPositionEmbedding,
                              TransformerFeedForward)
from ..nn.graph.computation_graph import ComputationGraph
from ..nn.graph.vertices import ElementWiseVertex


def transformer_lm_conf(vocab_size: int, d_model: int = 128,
                        num_heads: int = 4, num_layers: int = 2,
                        ff_mult: int = 4, max_length: int = 256,
                        drop_out: float = 0.0, learning_rate: float = 3e-4,
                        seed: int = 42):
    """ComputationGraphConfiguration for a GPT-style causal LM: input token
    ids [N, T] ("tokens"), output next-token distribution [N, T, vocab]."""
    g = (NeuralNetConfiguration.Builder().seed(seed)
         .learning_rate(learning_rate).updater("adam").weight_init("xavier")
         .graph_builder()
         .add_inputs("tokens"))
    keep = drop_out      # retention probability, like every layer conf
    g.add_layer("embed",
                TokenAndPositionEmbedding(n_in=vocab_size, n_out=d_model,
                                          max_length=max_length,
                                          drop_out=keep),
                "tokens")
    x = "embed"
    for i in range(num_layers):
        g.add_layer(f"ln{i}a",
                    LayerNormalization(n_in=d_model, n_out=d_model), x)
        g.add_layer(f"attn{i}",
                    SelfAttentionLayer(n_in=d_model, n_out=d_model,
                                       num_heads=num_heads, causal=True,
                                       drop_out=keep,
                                       activation="identity"),
                    f"ln{i}a")
        g.add_vertex(f"res{i}a", ElementWiseVertex(op="add"), x, f"attn{i}")
        g.add_layer(f"ln{i}b",
                    LayerNormalization(n_in=d_model, n_out=d_model),
                    f"res{i}a")
        g.add_layer(f"ffn{i}",
                    TransformerFeedForward(n_in=d_model, n_out=d_model,
                                           hidden_mult=ff_mult,
                                           drop_out=keep,
                                           activation="identity"),
                    f"ln{i}b")
        g.add_vertex(f"res{i}b", ElementWiseVertex(op="add"),
                     f"res{i}a", f"ffn{i}")
        x = f"res{i}b"
    g.add_layer("lnf", LayerNormalization(n_in=d_model, n_out=d_model), x)
    g.add_layer("out",
                RnnOutputLayer(n_in=d_model, n_out=vocab_size,
                               loss="mcxent", activation="softmax"), "lnf")
    g.set_outputs("out")
    return g.build()


def lm_batch_sparse(tokens: np.ndarray):
    """(features, integer labels) for next-token training from token ids
    [N, T+1]: inputs tokens[:, :-1], labels tokens[:, 1:], both [N, T]
    int32 — the fused sparse cross-entropy path (4 bytes a token instead
    of a [N, T, V] one-hot)."""
    return (np.asarray(tokens[:, :-1], np.int32),
            np.asarray(tokens[:, 1:], np.int32))


def generate(net: ComputationGraph, prompt_ids, length: int,
             temperature: float = 1.0,
             rng: Optional[np.random.Generator] = None,
             bucket: Optional[int] = None) -> np.ndarray:
    """Autoregressive sampling WITHOUT a KV cache — the no-cache reference
    the KV-cache decoder is held against. Every emitted token recomputes
    the full forward over the context right-padded to ``bucket`` (default:
    the model's max_length) and reads the logit at the true last position
    (causal attention never looks right, so padding is invisible). Greedy
    when temperature == 0; sampling draws from ``rng`` on the host."""
    rng = rng or np.random.default_rng(0)
    ids = list(np.asarray(prompt_ids, np.int64).reshape(-1))
    if bucket is None:
        bucket = net.conf.vertices["embed"].layer.max_length
    for _ in range(length):
        t = len(ids)
        if t > bucket:
            raise ValueError(f"context {t} exceeds bucket {bucket}")
        ctx = np.zeros((1, bucket), np.int64)
        ctx[0, :t] = ids
        probs = net.output(ctx)[0][0, t - 1]
        if temperature <= 0:
            nxt = int(np.argmax(probs))
        else:
            logits = np.log(np.maximum(probs, 1e-9)) / temperature
            p = np.exp(logits - logits.max())
            p /= p.sum()
            nxt = int(rng.choice(len(p), p=p))
        ids.append(nxt)
    return np.asarray(ids, np.int32)
