"""Port vs reference on the standalone l2dist and topk kernels.

``repro_torch.kernels.l2dist.ops.l2dist`` and ``...topk.ops.topk`` on CPU
tensors run their kernels' plain versions; the reference's
``l2dist_pallas`` and ``topk_pallas`` run in interpret mode. The
reference's ``topk`` wrapper raises NameError (ROADMAP C), so its kernel is
called directly with the wrapper's padding: N padded with +inf to the
n-block, indices past N mapped to -1. Integer-valued inputs make every
distance exact in f32 (bf16 holds integers up to 256 exactly), so l2dist
is bit-identical there; Gaussian inputs agree within the reference's
kernel tolerance (rtol=1e-5, atol=1e-4). topk moves values without
arithmetic, so it is bit-identical on every input, ties and -0.0/+0.0
included (no subnormal scores: ROADMAP C).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.l2dist.kernel import l2dist_pallas
from repro.kernels.l2dist.ops import l2dist as jl2dist
from repro.kernels.l2dist.ref import l2dist_ref as jl2dist_ref
from repro.kernels.topk.kernel import topk_pallas
from repro.kernels.topk.ref import topk_ref as jtopk_ref
from repro_torch.kernels.knn import kernel as K
from repro_torch.kernels.l2dist.kernel import l2dist_plain
from repro_torch.kernels.l2dist.ops import l2dist
from repro_torch.kernels.l2dist.ref import l2dist_ref
from repro_torch.kernels.topk.kernel import topk_scan, topk_scan_plain
from repro_torch.kernels.topk.ops import topk
from repro_torch.kernels.topk.ref import topk_ref

RTOL, ATOL = 1e-5, 1e-4
_DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _port_in(a, dtype):
    return torch.from_numpy(np.array(a)).to(_DTYPES[dtype][0])


def _jax_in(a, dtype):
    return jnp.asarray(a, dtype=_DTYPES[dtype][1])


# ------------------------------------------------------------------ l2dist
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,n,d", [(3, 7, 5), (13, 300, 77), (16, 513, 96)])
def test_l2dist_bit_identical_on_integer_data(m, n, d, dtype):
    rng = np.random.default_rng(m * n + d)
    q = rng.integers(-8, 9, (m, d)).astype(np.float32)
    x = rng.integers(-8, 9, (n, d)).astype(np.float32)
    x[n // 2] = q[0]  # distance 0
    got = l2dist(_port_in(q, dtype), _port_in(x, dtype)).numpy()
    want = np.asarray(jl2dist(_jax_in(q, dtype), _jax_in(x, dtype)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, l2dist_ref(_port_in(q, dtype), _port_in(x, dtype)).numpy())
    np.testing.assert_array_equal(got, np.asarray(jl2dist_ref(_jax_in(q, dtype), _jax_in(x, dtype))))
    assert got[0, n // 2] == 0.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_l2dist_close_on_gaussian_data(dtype):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((9, 130)).astype(np.float32)
    x = rng.standard_normal((260, 130)).astype(np.float32)
    got = l2dist(_port_in(q, dtype), _port_in(x, dtype)).numpy()
    # the TPU kernel itself, on the blocks its wrapper would pick
    qp, xp = np.pad(q, ((0, 7), (0, 126))), np.pad(x, ((0, 252), (0, 126)))
    want = np.asarray(l2dist_pallas(_jax_in(qp, dtype), _jax_in(xp, dtype), 16, 256, 256,
                                    interpret=True))[:9, :260]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jl2dist_ref(_jax_in(q, dtype), _jax_in(x, dtype))),
                               rtol=RTOL, atol=ATOL)


def test_l2dist_plain_rounds_in_the_kernel_order():
    q = torch.tensor([[1.0, 2.0]])
    x = torch.tensor([[1.0, 2.0], [3.0, -1.0]])
    qn, xn = torch.tensor([5.0]), torch.tensor([5.0, 10.0])
    assert torch.equal(l2dist_plain(q, x, qn, xn), torch.tensor([[0.0, 13.0]]))
    with pytest.raises(ValueError):
        l2dist(q, x.to(torch.bfloat16))


# -------------------------------------------------------------------- topk
def _reference_topk(s, k, block_m=8, block_n=256):
    """The reference's topk wrapper, with its padding, around topk_pallas."""
    m, n = s.shape
    k_eff = 1 << max(0, (k - 1).bit_length())
    bn = max(block_n, k_eff)
    mp, np_ = -(-m // block_m) * block_m, -(-n // bn) * bn
    sp = np.pad(s, ((0, mp - m), (0, np_ - n)), constant_values=np.inf)
    v, i = topk_pallas(jnp.asarray(sp), k_eff, block_m, bn, interpret=True)
    v, i = np.asarray(v)[:m, :k], np.asarray(i)[:m, :k]
    return v, np.where(i < n, i, -1)


@pytest.mark.parametrize("m,n,k,data", [
    (1, 1, 1, "gaussian"), (4, 2048, 10, "gaussian"),
    (3, 50, 100, "gaussian"),  # k > N: (+inf, -1) padding
    (5, 777, 33, "ties"),  # integer scores, -0.0 and +0.0 among them
])
def test_topk_matches_reference(m, n, k, data):
    rng = np.random.default_rng(m + n + k)
    s = rng.standard_normal((m, n)).astype(np.float32)
    if data == "ties":
        s = np.round(s * 2).astype(np.float32)
        zeros = s == 0  # -0.0 and +0.0 are one value: ties to the smaller index
        s[zeros] = np.where(rng.integers(0, 2, zeros.sum()) == 1, np.float32(-0.0), 0.0)
        assert np.signbit(s[zeros]).any() and not np.signbit(s[zeros]).all()
    v, i = topk(torch.from_numpy(s), k, block_n=256)  # small tiles: a quick interpret run
    rv, ri = _reference_topk(s, k)
    np.testing.assert_array_equal(v.numpy(), rv)
    np.testing.assert_array_equal(i.numpy(), ri)
    jv, ji = jtopk_ref(jnp.asarray(s), k)
    pv, pi = topk_ref(torch.from_numpy(s), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), pv.numpy())


def test_topk_split_scan_merges_to_the_sequential_queue():
    rng = np.random.default_rng(9)
    s = torch.from_numpy(np.round(rng.standard_normal((3, 5000)) * 3).astype(np.float32))
    v1, i1 = topk_scan_plain(s, 64, 256, 1)
    vs, is_ = topk_scan(s, 64, 1, 256, 7)  # CPU tensors: the plain version, S = 7
    assert vs.shape == (3, 7, 64)
    mv, mi = K.knn_merge(vs, is_)
    assert torch.equal(mv, v1[:, 0]) and torch.equal(mi, i1[:, 0])
    with pytest.raises(ValueError):
        topk_scan(s, 48, 1, 256)
    with pytest.raises(ValueError):
        topk_scan(s.to(torch.float64), 64, 1, 256)


def test_cpu_tensors_never_launch():
    K.reset_launch_counts()
    l2dist(torch.ones(2, 3), torch.ones(4, 3))
    topk(torch.ones(2, 30), 3)
    assert sum(K.LAUNCHES.values()) == 0
