"""InputType system: shape metadata used for nIn inference and automatic
preprocessor insertion (reference nn/conf/inputs/InputType.java and
nn/conf/layers/InputTypeUtil.java; SURVEY.md §2.1).

Layout note (TPU-first divergence from the reference): convolutional
activations are NHWC ([minibatch, height, width, channels] — XLA's preferred
TPU conv layout) and recurrent activations are [minibatch, time, features].
The reference uses NCHW / [minibatch, features, time]; the Keras importer and
dataset iterators own the conversion at the boundary.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .serde import register_config


@register_config
@dataclasses.dataclass(frozen=True)
class InputType:
    kind: str                      # "ff" | "rnn" | "cnn" | "cnnflat"
    size: int = 0                  # ff/rnn feature count
    timesteps: Optional[int] = None
    height: int = 0
    width: int = 0
    channels: int = 0

    # --- factories (InputType.feedForward/recurrent/convolutional parity) ---
    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType("ff", size=int(size))

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "InputType":
        return InputType("rnn", size=int(size), timesteps=timesteps)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType("cnn", height=int(height), width=int(width),
                         channels=int(channels))

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int) -> "InputType":
        return InputType("cnnflat", height=int(height), width=int(width),
                         channels=int(channels),
                         size=int(height) * int(width) * int(channels))

    def flat_size(self) -> int:
        if self.kind in ("ff", "rnn"):
            return self.size
        return self.height * self.width * self.channels

    def batch_shape(self) -> Tuple[Optional[int], ...]:
        """Example array shape (batch dim first, None = dynamic)."""
        if self.kind == "ff":
            return (None, self.size)
        if self.kind == "rnn":
            return (None, self.timesteps, self.size)
        if self.kind == "cnn":
            return (None, self.height, self.width, self.channels)
        return (None, self.size)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "InputType":
        return InputType(**d)
