"""Integrity checks of served state (the JAX package's
``observability/``)."""

from .integrity import page_content_checksum

__all__ = ["page_content_checksum"]
