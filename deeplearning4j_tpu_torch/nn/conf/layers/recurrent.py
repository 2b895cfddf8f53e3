"""Recurrent layers (the JAX package's ``nn/conf/layers/recurrent.py``):
``GravesLSTM`` (peepholes), ``LSTM`` and ``GravesBidirectionalLSTM``.

The input projection ``x @ W + b`` for all timesteps is one matmul outside
the recurrence ([N·T, nIn] × [nIn, 4H]); the recurrence itself is
``kernels/lstm.py``. On a CUDA tensor every LSTM goes to the helper
registry's ``lstm`` entry, the hand-written kernel B6, for f32 and bf16,
masked or not — unlike the JAX package, whose kernel is an opt-in helper
for f32 only. A gate / cell activation pair other than sigmoid / tanh
raises there instead of quietly running a loop of small kernels; CPU
tensors run the plain loop (any activation pair). Autograd differentiates
the recurrence (on the card through the kernel's ``LSTMRecurrence``).

Gate blocks along the 4H axis are [input, forget, cell (g), output]. The
layer's state carries (h, c) for ``rnn_time_step`` and truncated BPTT; the
carry lives in the promoted dtype of the input and W (a bf16 input against
f32 master weights computes in f32, as JAX promotes)."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ....kernels.lstm import lstm_recurrence_plain
from ....ops.activations import get_activation
from ...helpers import get_helper
from ..input_type import InputType
from ..serde import register_config
from .base import BaseRecurrentLayerConf


@register_config
@dataclasses.dataclass
class GravesLSTM(BaseRecurrentLayerConf):
    """LSTM with peephole connections (Graves 2013). ``activation`` is the
    cell / output activation (tanh by default), ``gate_activation`` the
    gates' (sigmoid)."""
    gate_activation: str = "sigmoid"
    forget_gate_bias_init: float = 1.0
    peephole: bool = True

    def init_params(self, gen, dtype=torch.float32) -> Dict:
        h = self.n_out
        dev = gen.device
        params = {
            "W": self._winit(gen, (self.n_in, 4 * h), self.n_in, h, dtype),
            "R": self._winit(gen, (h, 4 * h), h, h, dtype),
            "b": torch.cat([
                torch.zeros(h, dtype=dtype, device=dev),
                torch.full((h,), float(self.forget_gate_bias_init),
                           dtype=dtype, device=dev),
                torch.zeros(2 * h, dtype=dtype, device=dev)]),
        }
        if self.peephole:
            for k in ("pi", "pf", "po"):
                params[k] = torch.zeros(h, dtype=dtype, device=dev)
        return params

    def activation_names(self):
        """(gate activation, cell activation) as configured."""
        return (str(self.gate_activation).lower(),
                str(self.activation or "tanh").lower())

    def _acts(self):
        gate, cell = self.activation_names()
        return get_activation(gate), get_activation(cell)

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        """x [N, T, nIn] (mask [N, T]) → (y [N, T, H], {"h": hT, "c": cT}),
        starting from ``state``'s h / c (zeros when absent)."""
        x = self.maybe_dropout(x, train=train, gen=gen)
        n, t, _ = x.shape
        h = self.n_out
        dt = torch.promote_types(x.dtype, params["W"].dtype)
        h0 = state.get("h") if state else None
        c0 = state.get("c") if state else None
        zeros = lambda: torch.zeros((n, h), dtype=dt, device=x.device)
        h0 = zeros() if h0 is None else h0.to(dt)
        c0 = zeros() if c0 is None else c0.to(dt)
        W, R, b = (params[k].to(dt) for k in ("W", "R", "b"))
        peep = tuple(params[k].to(dt) for k in ("pi", "pf", "po")) \
            if self.peephole and "pi" in params else None
        xw = (x.to(dt).reshape(n * t, -1) @ W).reshape(n, t, 4 * h) + b
        xw_t = xw.transpose(0, 1)                       # [T, N, 4H] view
        mask_t = None if mask is None else mask.to(dt).transpose(0, 1)
        helper = get_helper("lstm", x.device)
        if helper is None:
            y_t, hT, cT = lstm_recurrence_plain(xw_t, R, h0, c0, peep,
                                                mask_t, *self._acts())
        else:
            y_t, hT, cT = helper(self, xw_t, R, h0, c0, peep, mask_t)
        return y_t.transpose(0, 1), {"h": hT, "c": cT}

    def step(self, params, state, x_t):
        """One inference step: x_t [N, nIn] → (y [N, H], new state)."""
        y, new_state = self.forward(params, state, x_t[:, None, :])
        return y[:, 0, :], new_state


@register_config
@dataclasses.dataclass
class LSTM(GravesLSTM):
    """Standard LSTM without peepholes."""
    peephole: bool = False


@register_config
@dataclasses.dataclass
class GravesBidirectionalLSTM(BaseRecurrentLayerConf):
    """Two independent peephole LSTMs, one over the reversed sequence,
    combined by ``mode``: "add" (the reference) or "concat". Parameters
    carry a ``_f`` / ``_b`` suffix per direction; the state is the forward
    direction's."""
    gate_activation: str = "sigmoid"
    forget_gate_bias_init: float = 1.0
    peephole: bool = True
    mode: str = "add"

    def get_output_type(self, it: InputType) -> InputType:
        out = self.n_out * (2 if self.mode == "concat" else 1)
        return InputType.recurrent(out, it.timesteps)

    def _dir_conf(self) -> GravesLSTM:
        return GravesLSTM(n_in=self.n_in, n_out=self.n_out,
                          activation=self.activation,
                          gate_activation=self.gate_activation,
                          weight_init=self.weight_init, dist=self.dist,
                          forget_gate_bias_init=self.forget_gate_bias_init,
                          peephole=self.peephole)

    def init_params(self, gen, dtype=torch.float32) -> Dict:
        sub = self._dir_conf()
        params = {f"{k}_f": v for k, v in sub.init_params(gen, dtype).items()}
        params.update({f"{k}_b": v for k, v in
                       sub.init_params(gen, dtype).items()})
        return params

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        x = self.maybe_dropout(x, train=train, gen=gen)
        sub = self._dir_conf()
        fwd = {k[:-2]: v for k, v in params.items() if k.endswith("_f")}
        bwd = {k[:-2]: v for k, v in params.items() if k.endswith("_b")}
        y_f, st_f = sub.forward(fwd, {}, x, mask)
        rev_mask = None if mask is None else torch.flip(mask, dims=(1,))
        y_b, _ = sub.forward(bwd, {}, torch.flip(x, dims=(1,)), rev_mask)
        y_b = torch.flip(y_b, dims=(1,))
        y = torch.cat([y_f, y_b], dim=-1) if self.mode == "concat" \
            else y_f + y_b
        return y, st_f
