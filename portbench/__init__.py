"""The benchmark of ``deeplearning4j_tpu_torch`` on NVIDIA GPUs: cells,
traffic, per-layer metric readers, the plain references and the
comparison that decides ``correct``. ``run.py`` is the entry point."""
