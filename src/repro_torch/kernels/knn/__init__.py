"""Fused exact kNN: the CUDA kernel wrapper (``kernel``) and its public
padding wrapper (``ops``)."""
