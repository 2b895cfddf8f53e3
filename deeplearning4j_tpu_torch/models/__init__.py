"""The transformer LM (configuration, training batches), its KV-cache
decoder and the slot engine."""

from .transformer import generate, lm_batch_sparse, transformer_lm_conf
from .generation import (TransformerDecoder, SlotGenerationEngine,
                         GenerationRequest)

__all__ = ["transformer_lm_conf", "lm_batch_sparse", "generate",
           "TransformerDecoder",
           "SlotGenerationEngine", "GenerationRequest"]
