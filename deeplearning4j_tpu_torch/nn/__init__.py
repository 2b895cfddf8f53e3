"""Network core: configuration, layers, vertices, ComputationGraph and the
helper registry."""
