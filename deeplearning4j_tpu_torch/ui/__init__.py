"""The port's HTTP serving base (the JAX package's ``ui/``: only the
server plumbing the telemetry endpoint needs)."""

from .server import BackgroundHTTPServer, JsonHTTPHandler

__all__ = ["BackgroundHTTPServer", "JsonHTTPHandler"]
