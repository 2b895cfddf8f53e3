"""Per-layer metric readers, one file a metric (see README.md)."""
