"""The transformer LM, its KV-cache decoder and the slot engine."""

from .transformer import transformer_lm_conf, generate
from .generation import (TransformerDecoder, SlotGenerationEngine,
                         GenerationRequest)

__all__ = ["transformer_lm_conf", "generate", "TransformerDecoder",
           "SlotGenerationEngine", "GenerationRequest"]
