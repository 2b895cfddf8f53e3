"""The transformer LM (configuration, training batches), its KV-cache
decoder and the slot engine; the GravesLSTM character RNN."""

from .char_rnn import CharacterIterator, char_rnn_conf
from .transformer import generate, lm_batch_sparse, transformer_lm_conf
from .generation import (TransformerDecoder, SlotGenerationEngine,
                         GenerationRequest)

__all__ = ["char_rnn_conf", "CharacterIterator",
           "transformer_lm_conf", "lm_batch_sparse", "generate",
           "TransformerDecoder",
           "SlotGenerationEngine", "GenerationRequest"]
