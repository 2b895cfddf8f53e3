"""Plain PyTorch references of what the benchmark's cells run, one module
per configuration ``architecture``. They import neither JAX nor the
program under test."""
