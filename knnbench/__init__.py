"""knnbench: the end-to-end benchmark of the PyTorch and CUDA port ``repro_torch``.

See README.md. Nothing here imports ``jax`` or the JAX package ``repro``.
"""
