"""Canonical per-role partition specs for the serving decoder (the JAX
package's ``parallel/spec_layout.py``).

:class:`SpecLayout` owns the axis names and the per-role specs;
:func:`decoder_param_specs` walks a ``TransformerDecoder``'s graph and
assigns a spec to every parameter leaf by (layer type, parameter name);
:func:`validate_param_specs` rank- and divisibility-checks the table
against the decoder's actual parameters before any device work, so a bad
layout fails with the offending vertex / param named; and
:func:`shard_params` places every leaf's part on each mesh coordinate's
device.

Layout (tp = tensor parallel, data = batch / cache slots, optional fsdp):

- embeddings (token table ``W`` [V, D], positions ``P`` [T, D]): model
  dim over ``tp`` (optionally rows over ``fsdp``): each shard embeds its
  D slice and the slices concatenate into the replicated hidden state;
- attention ``Wq/Wk/Wv`` [D, H·Dh]: column-parallel over ``tp`` (a shard
  holds H/tp whole heads, exactly how the [S, H, T, Dh] cache shards its
  H); ``Wo`` [H·Dh, D]: row-parallel (the shards' partial products are
  summed in coordinate order and ``bo`` is added once, after the sum);
- FFN ``W1`` column-parallel with ``b1``, ``W2`` row-parallel, ``b2``
  replicated and added once;
- layer norms replicated; the vocab head column-parallel over ``tp``
  (logits [B, V] split on V until they are concatenated for the
  selection).

``fsdp_axis`` is optional and may name the data axis (FSDP on the 2-axis
serving mesh: parameters split over the batch axis as well, and each use
gathers the parts it needs)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .mesh import DATA_AXIS, TP_AXIS, Mesh, P, local_slice


@dataclasses.dataclass(frozen=True)
class SpecLayout:
    """Canonical partition specs per parameter role for decoder serving."""

    data_axis: str = DATA_AXIS
    tp_axis: str = TP_AXIS
    #: optional parameter-sharding axis; the data axis's name runs
    #: FSDP-style parameter sharding on a 2-axis serving mesh
    fsdp_axis: Optional[str] = None

    # ------------------------------------------------------- param roles
    def embedding(self) -> P:
        """Token / position tables [V|T, D]: model dim over tp."""
        return P(self.fsdp_axis, self.tp_axis)

    def qkv_projection(self) -> P:
        """Wq/Wk/Wv [D, H*Dh]: column-parallel — heads split over tp."""
        return P(self.fsdp_axis, self.tp_axis)

    def attn_out(self) -> P:
        """Wo [H*Dh, D]: row-parallel (contraction over the tp shards)."""
        return P(self.tp_axis, self.fsdp_axis)

    def ffn_up(self) -> P:
        return P(self.fsdp_axis, self.tp_axis)

    def ffn_down(self) -> P:
        return P(self.tp_axis, self.fsdp_axis)

    def col_bias(self) -> P:
        """Bias of a column-parallel projection: follows the tp shards."""
        return P(self.tp_axis)

    def replicated(self) -> P:
        return P()

    def head(self) -> P:
        """Vocab projection [D, V]: logits split on V over tp."""
        return P(self.fsdp_axis, self.tp_axis)

    # ------------------------------------------------- activations/cache
    def kv_cache(self) -> P:
        """[S, H, T_max, Dh]: slots over data, heads over tp."""
        return P(self.data_axis, self.tp_axis, None, None)

    def kv_pages(self) -> P:
        """Paged pool [P, H, page_size, Dh]: heads over tp like the slab's
        H dim. Pages do not split over data — any slot may map any page —
        so every data group holds a copy of the pool and every write goes
        to all copies."""
        return P(None, self.tp_axis, None, None)

    def batch(self, ndim: int = 1) -> P:
        """Per-row inputs (ids / positions / temps [B], tokens [B, T]):
        batch over data."""
        return P(self.data_axis, *([None] * (ndim - 1)))


def decoder_param_specs(decoder, layout: Optional[SpecLayout] = None
                        ) -> Dict[str, Dict[str, P]]:
    """{vertex_name: {param_name: spec}} for the vertices of a
    TransformerDecoder's graph; unlisted params replicate. Assignment is
    by (layer type, parameter name)."""
    from ..nn.conf.layers import (SelfAttentionLayer,
                                  TokenAndPositionEmbedding,
                                  TransformerFeedForward)
    from ..nn.graph.vertices import LayerVertex

    layout = layout or SpecLayout()
    conf = decoder.net.conf
    specs: Dict[str, Dict[str, P]] = {}
    for name in conf.topological_order:
        v = conf.vertices[name]
        if not isinstance(v, LayerVertex):
            continue
        layer = v.layer
        if isinstance(layer, TokenAndPositionEmbedding):
            specs[name] = {"W": layout.embedding(), "P": layout.embedding()}
        elif isinstance(layer, SelfAttentionLayer):
            s = {"Wq": layout.qkv_projection(),
                 "Wk": layout.qkv_projection(),
                 "Wv": layout.qkv_projection()}
            if layer.project_out:
                s["Wo"] = layout.attn_out()
                s["bo"] = layout.replicated()
            specs[name] = s
        elif isinstance(layer, TransformerFeedForward):
            specs[name] = {"W1": layout.ffn_up(), "b1": layout.col_bias(),
                           "W2": layout.ffn_down(),
                           "b2": layout.replicated()}
        elif name == decoder.output_name:
            specs[name] = {"W": layout.head(), "b": layout.col_bias()}
    return specs


def validate_param_specs(mesh: Mesh, specs: Dict[str, Dict[str, P]],
                         params) -> None:
    """Check a name-based spec table against the actual parameter tree:
    every spec's rank must not exceed its leaf's rank, every named axis
    must exist on the mesh, and every split dim must divide by its axis
    size. Raises ValueError naming the offending vertex / param."""
    problems = []
    for vname, table in specs.items():
        leaves = params.get(vname, {})
        for pname, spec in table.items():
            if pname not in leaves:
                problems.append(f"{vname}.{pname}: spec for a parameter "
                                "the decoder does not have")
                continue
            leaf = leaves[pname]
            entries = tuple(spec)
            if len(entries) > leaf.ndim:
                problems.append(
                    f"{vname}.{pname}: spec {spec} has {len(entries)} "
                    f"entries but the leaf is rank {leaf.ndim} "
                    f"(shape {tuple(leaf.shape)}) — a partition spec's "
                    "rank cannot exceed the leaf's rank")
                continue
            for dim, axis in enumerate(entries):
                if axis is None:
                    continue
                axes = axis if isinstance(axis, tuple) else (axis,)
                for ax in axes:
                    size = mesh.shape.get(ax)
                    if size is None:
                        problems.append(
                            f"{vname}.{pname}: spec {spec} names axis "
                            f"'{ax}' absent from the mesh axes "
                            f"{tuple(mesh.axis_names)}")
                    elif leaf.shape[dim] % size:
                        problems.append(
                            f"{vname}.{pname}: dim {dim} of shape "
                            f"{tuple(leaf.shape)} is not divisible by "
                            f"axis '{ax}' size {size}")
    if problems:
        raise ValueError("invalid parameter sharding layout:\n  " +
                         "\n  ".join(problems))


def param_shardings(mesh: Mesh, specs: Dict[str, Dict[str, P]],
                    params) -> Dict[str, Dict[str, P]]:
    """The spec of every leaf, in exactly ``params``' structure; unlisted
    leaves replicate."""
    return {vname: {pname: specs.get(vname, {}).get(pname, P())
                    for pname in leaves}
            for vname, leaves in params.items()}


def shard_params(mesh: Mesh, specs: Dict[str, Dict[str, P]],
                 params) -> Dict[tuple, Dict[str, Dict]]:
    """{mesh coordinate: params tree}: each coordinate's part of every
    leaf (by ``specs``; unlisted leaves whole) on that coordinate's
    device, contiguous. One copy per coordinate, made once."""
    table = param_shardings(mesh, specs, params)
    return {c: {vname: {pname: local_slice(mesh, table[vname][pname], c,
                                           leaf).to(mesh.device(c))
                        .contiguous()
                        for pname, leaf in leaves.items()}
                for vname, leaves in params.items()}
            for c in mesh.coords()}
