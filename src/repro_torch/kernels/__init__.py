"""Hand-written CUDA kernels for Hopper and their plain torch versions.

knn     — fused distance + top-k queue: ``knn_scan`` (f32/bf16 rows,
          ``csrc/knn.cu``) and ``knn_int8_scan`` (int8 codes, certified
          lower bounds, ``csrc/knn_int8.cu``), reduced by ``knn_merge``
          (``knn/kernel.py``, ``csrc/knn.cu``)
l2dist  — the squared-L2 distance matrix: a streamed scan for small
          batches, a tiled f32 product for large ones (``l2dist/kernel.py``,
          ``csrc/l2dist.cu``)
topk    — streaming top-k over a score matrix, reduced by ``knn_merge``
          (``topk/kernel.py``, ``csrc/topk.cu``)
select  — the survivor filter ``knn_scan``, ``knn_int8_scan`` and ``topk``
          fold their batches through (``csrc/select.cuh``)
bitonic — the compare-exchange networks the queues use (``bitonic.py`` is
          the plain reference of ``csrc/bitonic.cuh``)

The scans and both ``l2dist`` kernels bring their operands in through the
``cp.async`` helpers of ``csrc/ring.cuh``.
Kernels are built by ``build.py`` at first launch, never at import; every
wrapper counts its launches in ``knn.kernel.LAUNCHES``.
"""
