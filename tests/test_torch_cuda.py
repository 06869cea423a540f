"""The CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA card with ``nvcc`` (the library is built on
first launch); elsewhere they skip. They import neither JAX nor the JAX
package, so a machine with only PyTorch runs them:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Integer-valued data keeps every sum exact in f32, so the kernel and its
plain version must agree bit for bit.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch import ExactKNN, SearchRequest
from repro_torch.kernels.knn import kernel as K
from repro_torch.kernels.knn import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ints(shape, g, dev):
    return torch.randint(-8, 9, shape, generator=g, device=dev).to(torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("k,m", [(1, 1), (7, 16), (72, 3), (1024, 2)])
def test_fused_kernel_bit_identical_to_plain(dev, dtype, metric, k, m):
    g = torch.Generator(device=dev).manual_seed(k + m)
    x = _ints((5000, 256), g, dev)
    x[4000] = x[9]
    q = _ints((m, 256), g, dev)
    q[0] = x[9]
    xn = torch.sum(x * x, dim=-1)
    xn[[100, 4999]] = torch.inf
    call = ops.prepare(q.to(dtype), x.to(dtype), k, metric, xn)
    bm, bn, bd = call.blocks
    K.reset_launch_counts()
    v, i, sk = K.knn_fused(call.q, call.x, call.xn, call.k_eff, call.metric, bm, bn, bd)
    torch.cuda.synchronize()
    assert K.LAUNCHES["knn_scan"] == 1 and K.LAUNCHES["knn_merge"] >= 1
    pv, pi, _ = K.knn_fused_plain(call.q, call.x, call.xn, call.k_eff, call.metric, bm, bn, bd)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert int(sk.sum()) <= (call.q.shape[0] // bm) * (call.x.shape[0] // bn)


def test_engine_searches_through_the_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    x = _ints((20_000, 100), g, dev)
    q = _ints((6, 100), g, dev)
    fused = ExactKNN(k=10, backend="cuda").fit(x)
    plain = ExactKNN(k=10, backend="torch").fit(x)
    for mode in ("fdsq", "fqsd"):
        K.reset_launch_counts()
        got = fused.search(SearchRequest(queries=q, mode_hint=mode))
        torch.cuda.synchronize()
        assert got.plan.executor == "fdsq-cuda" and all(K.LAUNCHES.values())
        want = plain.search(SearchRequest(queries=q, mode_hint=mode))
        assert torch.equal(got.topk.scores, want.topk.scores)
        assert torch.equal(got.topk.indices, want.topk.indices)
