"""Squared-L2 distance matrix: the CUDA kernel wrapper (``kernel``), its
public padding wrapper (``ops``) and its plain oracle (``ref``)."""
