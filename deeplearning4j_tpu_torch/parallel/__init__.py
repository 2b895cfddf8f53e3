"""Serving errors."""

from .faults import RejectedError

__all__ = ["RejectedError"]
