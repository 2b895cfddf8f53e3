"""Input preprocessors: the shape adapters between layer families (the JAX
package's ``nn/conf/preprocessors.py``), registered under the same names
with the same fields, so configurations carrying them read and write the
same JSON. Layouts are the JAX package's: NHWC for convolutional
activations, [N, T, F] for recurrent ones. Autograd differentiates the
reshapes."""

from __future__ import annotations

import dataclasses

from .input_type import InputType
from .serde import register_config


class InputPreProcessor:
    def pre_process(self, x, mask=None):
        raise NotImplementedError

    def output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def feed_forward_mask(self, mask):
        """The mask after this preprocessor (passed through unchanged)."""
        return mask


@register_config
@dataclasses.dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """[N, H, W, C] → [N, H·W·C]."""
    height: int = 0
    width: int = 0
    channels: int = 0

    def pre_process(self, x, mask=None):
        return x.reshape(x.shape[0], -1)

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(it.height * it.width * it.channels)


@register_config
@dataclasses.dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """[N, H·W·C] → [N, H, W, C]."""
    height: int = 0
    width: int = 0
    channels: int = 0

    def pre_process(self, x, mask=None):
        if x.dim() == 4:
            return x
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, it: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)


@register_config
@dataclasses.dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """[N·T, F] → [N, T, F], where dense layers feed a recurrent one."""
    timesteps: int = dataclasses.field(default=0)

    def pre_process(self, x, mask=None):
        return x.reshape(-1, self.timesteps, x.shape[-1])

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(it.size, self.timesteps or None)


@register_config
@dataclasses.dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[N, T, F] → [N·T, F] (a dense layer applied per timestep)."""

    def pre_process(self, x, mask=None):
        return x.reshape(-1, x.shape[-1])

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(it.size)


@register_config
@dataclasses.dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    """[N·T, H, W, C] → [N, T, H·W·C] (T = ``timesteps``, 1 by default)."""
    height: int = 0
    width: int = 0
    channels: int = 0
    timesteps: int = 1

    def pre_process(self, x, mask=None):
        flat = x.reshape(x.shape[0], -1)
        return flat.reshape(-1, self.timesteps, flat.shape[-1])

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(it.height * it.width * it.channels,
                                   self.timesteps)


@register_config
@dataclasses.dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    """[N, T, H·W·C] → [N·T, H, W, C]."""
    height: int = 0
    width: int = 0
    channels: int = 0

    def pre_process(self, x, mask=None):
        n, t, _ = x.shape
        return x.reshape(n * t, self.height, self.width, self.channels)

    def output_type(self, it: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)


def auto_preprocessor(prev: InputType, needed_kind: str, **kw):
    """The preprocessor bridging ``prev`` to a layer that expects
    ``needed_kind`` input, or None when none is needed."""
    if prev.kind == needed_kind:
        return None
    if prev.kind == "cnnflat" and needed_kind == "cnn":
        return FeedForwardToCnnPreProcessor(prev.height, prev.width,
                                            prev.channels)
    if prev.kind == "cnnflat" and needed_kind == "ff":
        return None
    if prev.kind == "cnn" and needed_kind == "ff":
        return CnnToFeedForwardPreProcessor(prev.height, prev.width,
                                            prev.channels)
    if prev.kind == "ff" and needed_kind == "cnn":
        return FeedForwardToCnnPreProcessor(kw.get("height"), kw.get("width"),
                                            kw.get("channels"))
    if prev.kind == "rnn" and needed_kind == "ff":
        return RnnToFeedForwardPreProcessor()
    if prev.kind == "ff" and needed_kind == "rnn":
        return FeedForwardToRnnPreProcessor(kw.get("timesteps", 0))
    if prev.kind == "cnn" and needed_kind == "rnn":
        return CnnToRnnPreProcessor(prev.height, prev.width, prev.channels,
                                    kw.get("timesteps", 1))
    if prev.kind == "rnn" and needed_kind == "cnn":
        return RnnToCnnPreProcessor(kw.get("height"), kw.get("width"),
                                    kw.get("channels"))
    return None
