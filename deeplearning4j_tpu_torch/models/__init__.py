"""The transformer LM (configuration, training batches), its KV-cache
decoder and the slot engine (slab or paged, with the prefix cache and
speculative decoding); the GravesLSTM character RNN."""

from .char_rnn import CharacterIterator, char_rnn_conf
from .transformer import generate, lm_batch_sparse, transformer_lm_conf
from .generation import (TransformerDecoder, SlotGenerationEngine,
                         GenerationRequest)
from .paging import PageAllocator, prefix_route_key

__all__ = ["char_rnn_conf", "CharacterIterator",
           "transformer_lm_conf", "lm_batch_sparse", "generate",
           "TransformerDecoder",
           "SlotGenerationEngine", "GenerationRequest",
           "PageAllocator", "prefix_route_key"]
