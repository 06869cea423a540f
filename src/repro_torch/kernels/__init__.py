"""Hand-written CUDA kernels for Hopper and their plain torch versions.

knn     — fused distance + top-k queue (``knn/kernel.py``, ``csrc/knn.cu``)
bitonic — the compare-exchange networks the queue uses (``bitonic.py`` is
          the plain reference of ``csrc/bitonic.cuh``)

Kernels are built by ``build.py`` at first launch, never at import.
"""
