"""The FQ-SD ring through the Router's multi-device entry, held to a plain
float64 brute force, and the placement of its blocks.

``Router.create(name, rows, devices=["cpu"] * 4)`` builds a one-axis
``("data",)`` mesh of four logical positions, whose FQ-SD executor is
``sharded.fqsd_ring`` (``fqsd-sharded``); ``backend="cuda"`` runs the
kernels' plain versions on the CPU. The shapes are YFCC100M-HNfc6's width
(d = 4,096) and the benchmark ring cell's k = 1,024 and batch of 256 (64
queries a position), and a batch of 16 (4 a position). The brute force is
a few lines of plain torch in float64, independent of the port.

Rows and queries are integers in [-8, 8]: every product, sum and norm of a
distance is an integer below 2^24, exact in f32 as in float64, so the
ring's ids must equal the brute force's (ties to the smaller id on both
sides), and its scores may differ by no more than one f32 rounding of the
distance (2^-24 of it, relative): a larger gap is a wrong row, not
rounding.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import SearchRequest
from repro_torch.api import Router
from repro_torch.core import sharded as sh
from repro_torch.core.mesh import make_mesh

N, D, K = 8192, 4096, 1024


def _ints(shape, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-8, 9, shape, generator=g).to(torch.float32)


def _brute_force(q: torch.Tensor, x: torch.Tensor, k: int):
    """Exact k nearest by L2 in float64, ties to the smaller id."""
    q, x = q.to(torch.float64), x.to(torch.float64)
    d = (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2.0 * (q @ x.T)
    dist, ids = torch.sort(d, dim=1, stable=True)
    return dist[:, :k], ids[:, :k]


@pytest.fixture(scope="module")
def ring():
    x = _ints((N, D), 0)
    eng = Router().create("yfcc", x, devices=["cpu"] * 4, k=K, backend="cuda", device="cpu")
    return eng, x


@pytest.mark.parametrize("m", [16, 256])
def test_the_ring_through_the_router_is_the_float64_brute_force(ring, m):
    eng, x = ring
    q = _ints((m, D), m)
    res = eng.search(SearchRequest(queries=q, mode_hint="fqsd"))
    assert res.plan.executor == "fqsd-sharded"
    assert [str(d) for d in eng.mesh.devices.flat] == ["cpu"] * 4
    dist, ids = _brute_force(q, x, K)
    assert torch.equal(res.topk.indices.to(torch.int64), ids)
    torch.testing.assert_close(res.topk.scores.to(torch.float64), dist, rtol=2.0 ** -24,
                               atol=0.0)


def test_a_block_on_a_card_of_its_own_stops_viewing_its_source():
    """On logical positions of one device a block stays a view of its
    source (no second copy of the rows on that card); where its device
    holds no other block (distinct devices: ``meta`` stands in for the
    other cards here), the block on the source's device gets memory of its
    own, so dropping the source frees all but that block."""
    t = _ints((4096, 64), 1)
    logical = sh.shard_rows(make_mesh((4,), ("data",), devices=["cpu"] * 4), t, "data")
    assert all(b.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
               for b in logical.local)
    cards = make_mesh((4,), ("data",), devices=["cpu"] * 4)
    # a Mesh takes one device type: positions 1-3 moved to "meta" afterwards
    cards.devices = np.array([torch.device(d) for d in ("cpu", "meta", "meta", "meta")],
                             dtype=object)
    distinct = sh.shard_rows(cards, t, "data")
    own = distinct.local[0]
    assert own.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()
    assert own.untyped_storage().nbytes() == own.nbytes == t.nbytes // 4
    assert torch.equal(own, t[:1024])
    assert [b.device.type for b in distinct.local[1:]] == ["meta"] * 3
    # a block that is its whole storage is kept as it is
    one = sh.shard_rows(make_mesh((1,), ("data",), devices=["cpu"]), t, "data")
    assert one.local[0].untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
