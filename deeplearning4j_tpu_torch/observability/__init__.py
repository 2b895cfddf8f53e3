"""Integrity checks of served state and the serving tier's interval clock
(the JAX package's ``observability/``)."""

from .clock import interval_now
from .integrity import (IntegrityConfig, NumericalFault, PageVerifier,
                        as_integrity, corrupt_host_frames, logits_fault,
                        page_content_checksum)

__all__ = ["IntegrityConfig", "NumericalFault", "PageVerifier",
           "as_integrity", "corrupt_host_frames", "interval_now",
           "logits_fault", "page_content_checksum"]
