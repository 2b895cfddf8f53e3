"""Tensor-adjacent substrate: activations, seeded init, device placement and
the device→host transfer seam."""
