"""Model building blocks on (B, C, T) activations, PyTorch's conv layout.

The JAX package keeps activations channels-last (B, T, C); the tests
transpose at their boundary. Weights use PyTorch's layouts: conv
(C_out, C_in, K), dense (C_out, C_in).
"""
