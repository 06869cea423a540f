"""The port's public surface, held to the reference's snapshot.

``tests/test_api_surface.py`` pins ``repro.api``: its ``__all__``, the
request and result fields and defaults, and the deprecated shims, which
must warn and keep working. The port's ``api`` must match it name for
name, ``core.__all__`` must be the reference's, the seven mesh names
included, and ``serving``, ``optim``, ``checkpoint`` and ``data`` export the
reference's names (``DecodeServer`` and ``click_log_stream`` too).
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.checkpoint as jcheckpoint
import repro.core as jcore
import repro.data as jdata
import repro.optim as joptim
import repro.serving as jserving
import repro_torch.api as api
import repro_torch.checkpoint as checkpoint
import repro_torch.core as core
import repro_torch.data as data
import repro_torch.optim as optim
import repro_torch.serving as serving
from repro.configs import get_config as jget_config
from repro_torch.api import SearchRequest, SearchResult
from repro_torch.core import ExactKNN

API_ALL = ("SearchRequest", "SearchResult", "Router")
MESH_NAMES = {"MeshTiered", "fdsq_sharded", "fdsq_sharded_int8", "fqsd_sharded", "fqsd_ring",
              "shard_dataset", "make_ring_put"}

SEARCH_REQUEST_FIELDS = (
    "queries", "k", "metric", "tier", "mode_hint", "deadline_ms",
    "filter_mask", "prefetch_depth", "spec_trigger", "allow_partial",
    "max_retries", "rid", "arrival_s",
)

SEARCH_RESULT_FIELDS = (
    "topk", "plan", "tier", "certified", "kernel_stats", "stats", "rid",
)


def test_api_all_snapshot():
    assert api.__all__ == tuple(japi.__all__) == API_ALL
    for name in API_ALL:
        assert hasattr(api, name)
    from repro_torch.api.types import AUTO_FDSQ_MAX_BATCH
    from repro.api.types import AUTO_FDSQ_MAX_BATCH as J_AUTO

    assert AUTO_FDSQ_MAX_BATCH == J_AUTO


def test_core_all_is_the_reference_less_the_mesh():
    """The mesh names are ported now: ``core.__all__`` is the reference's."""
    assert list(core.__all__) == list(jcore.__all__)
    assert MESH_NAMES <= set(core.__all__)
    for name in core.__all__:
        obj = getattr(core, name)
        assert obj.__module__.startswith("repro_torch."), name


@pytest.mark.parametrize("port,ref,left_out", [
    (serving, jserving, set()),
    (data, jdata, set()),
    (optim, joptim, set()),
    (checkpoint, jcheckpoint, set()),
])
def test_serving_and_data_all(port, ref, left_out):
    assert list(port.__all__) == [n for n in ref.__all__ if n not in left_out]
    assert left_out <= set(ref.__all__)
    for name in port.__all__:
        assert getattr(port, name).__module__.startswith("repro_torch."), name


def test_request_and_result_field_snapshot():
    assert tuple(f.name for f in dataclasses.fields(SearchRequest)) == SEARCH_REQUEST_FIELDS
    assert tuple(f.name for f in dataclasses.fields(SearchResult)) == SEARCH_RESULT_FIELDS
    with pytest.raises(dataclasses.FrozenInstanceError):
        SearchRequest(queries=np.zeros(4)).k = 3


def test_request_defaults_snapshot():
    r = SearchRequest(queries=np.zeros(4, np.float32))
    assert (r.k, r.metric, r.tier, r.mode_hint) == (None, None, "auto", "auto")
    assert (r.deadline_ms, r.filter_mask, r.rid, r.arrival_s) == (None, None, None, 0.0)
    assert (r.prefetch_depth, r.spec_trigger) == (None, None)
    assert (r.allow_partial, r.max_retries) == (False, None)


def test_knn_paper_config_matches_the_reference():
    from repro_torch.configs import get_config

    got, want = get_config("knn-search"), jget_config("knn-search")
    assert [(s.name, s.kind, dict(s.dims)) for s in got.shapes] == \
        [(s.name, s.kind, dict(s.dims)) for s in want.shapes]
    for a, b in ((got.model, want.model), (got.smoke_model, want.smoke_model)):
        assert (a.name, a.n_vectors, a.dim, a.n_queries) == (b.name, b.n_vectors, b.dim,
                                                             b.n_queries)
        assert a.dtype is torch.float32
    assert got.shape("gist_fqsd")["n"] == 1_000_000
    assert get_config("dlrm-rm2").family == "recsys"  # the recommenders are ported
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("resnet-50")


class TestShimDeprecations:
    """Every legacy entry point warns DeprecationWarning ("deprecated") and
    returns what ``search`` returns."""

    @pytest.fixture
    def engine(self):
        rng = np.random.default_rng(0)
        x = rng.integers(-4, 5, (640, 16)).astype(np.float32)
        return ExactKNN(k=3, n_partitions=2, device="cpu").fit(x).enable_int8()

    @pytest.mark.parametrize("name,call,request_kw", [
        ("query", lambda e, q: e.query(q[0]), dict(mode_hint="fdsq")),
        ("query_batch", lambda e, q: e.query_batch(q), dict(mode_hint="fqsd")),
        ("query_batch_int8", lambda e, q: e.query_batch_int8(q), dict(tier="int8")),
        ("query_stream", lambda e, q: list(e.query_stream([q[0], q[1]])),
         dict(mode_hint="fdsq")),
    ])
    def test_engine_shims_warn_and_delegate(self, engine, name, call, request_kw):
        q = np.random.default_rng(1).integers(-4, 5, (5, 16)).astype(np.float32)
        with pytest.warns(DeprecationWarning, match="deprecated"):
            got = call(engine, q)
        if name == "query_stream":
            for row, out in enumerate(got):
                want = engine.search(SearchRequest(queries=q[row], **request_kw)).topk
                assert out.scores.shape == (3,)
                assert torch.equal(out.scores, want.scores[0])
                assert torch.equal(out.indices, want.indices[0])
            return
        want = engine.search(SearchRequest(queries=q[0] if name == "query" else q,
                                           **request_kw)).topk
        assert torch.equal(got.scores, want.scores) and torch.equal(got.indices, want.indices)

    def test_search_streamed_shim_warns(self, engine):
        with pytest.warns(DeprecationWarning, match="deprecated"):
            engine.search_streamed(np.zeros((5, 16), np.float32),
                                   np.zeros((256, 16), np.float32), rows_per_partition=128)

    def test_serving_request_shim_warns(self):
        from repro_torch.serving import Request, Result

        with pytest.warns(DeprecationWarning, match="SearchRequest"):
            r = Request(1, np.zeros(8, np.float32), arrival_s=2.0)
        assert isinstance(r, SearchRequest)
        assert (r.rid, r.arrival_s) == (1, 2.0)
        assert Result is SearchResult

    def test_search_itself_does_not_warn(self, engine):
        q = np.zeros((5, 16), np.float32)
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            engine.search(SearchRequest(queries=q))
            engine.search(SearchRequest(queries=q, tier="int8"))


def test_fdsq_query_stream_and_merge_two_sorted_match_the_reference():
    """The two building blocks this surface adds, against the reference's on
    the same integer rows."""
    import jax.numpy as jnp

    from repro.core import TopK as JTopK

    rng = np.random.default_rng(3)
    x = rng.integers(-4, 5, (512, 16)).astype(np.float32)
    xn = (x * x).sum(-1)
    qs = [rng.integers(-4, 5, 16).astype(np.float32) for _ in range(3)]
    got = list(core.fdsq_query_stream(qs, torch.from_numpy(x), torch.from_numpy(xn), 7,
                                      n_partitions=4))
    want = list(jcore.fdsq_query_stream(qs, jnp.asarray(x), jnp.asarray(xn), 7, n_partitions=4))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.scores.numpy(), np.asarray(w.scores))
        np.testing.assert_array_equal(g.indices.numpy(), np.asarray(w.indices))
    a_s, b_s = np.sort(rng.integers(0, 50, (2, 4, 6)).astype(np.float32), -1)
    a_i, b_i = rng.permutation(48).astype(np.int32).reshape(2, 4, 6)
    got = core.merge_two_sorted(core.TopK(torch.from_numpy(a_s), torch.from_numpy(a_i)),
                                core.TopK(torch.from_numpy(b_s), torch.from_numpy(b_i)))
    want = jcore.merge_two_sorted(JTopK(jnp.asarray(a_s), jnp.asarray(a_i)),
                                  JTopK(jnp.asarray(b_s), jnp.asarray(b_i)))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))


def test_server_all_is_the_reference():
    import repro.server as jserver
    import repro_torch.server as server

    assert list(server.__all__) == list(jserver.__all__)
    for name in server.__all__:
        assert getattr(server, name).__module__.startswith("repro_torch.server."), name


LISTEN_FLAGS = ("listen", "max_inflight", "tenant_qps", "queue_timeout_ms")


@pytest.mark.parametrize("argv", [
    [],
    ["--listen", "0.0.0.0:8440", "--max-inflight", "64", "--tenant-qps", "12.5",
     "--queue-timeout-ms", "250"],
    ["--listen", "localhost:0", "--tenant-qps", "1e3"],
])
def test_serve_parser_takes_the_reference_listen_flags(monkeypatch, argv):
    """launch.serve's parser takes the reference's --listen, --max-inflight,
    --tenant-qps and --queue-timeout-ms with the same defaults and values."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    seen = []
    monkeypatch.setattr(jserve, "serve_knn", seen.append)
    jserve.main(["--mode", "knn", *argv])
    got = serve.parser().parse_args(["--mode", "knn", *argv])
    assert [getattr(got, f) for f in LISTEN_FLAGS] == [getattr(seen[0], f) for f in LISTEN_FLAGS]


@pytest.mark.parametrize("argv", [
    ["--listen", "8440"], ["--listen", ":8440"], ["--listen", "h:65536"], ["--listen", "h:p"],
    ["--max-inflight", "0"], ["--tenant-qps", "-1"], ["--tenant-qps", "nan"],
    ["--queue-timeout-ms", "0"], ["--queue-timeout-ms", "inf"],
])
def test_serve_parser_refuses_what_the_reference_refuses(monkeypatch, argv):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    monkeypatch.setattr(jserve, "serve_knn", lambda args: None)
    with pytest.raises(SystemExit):
        jserve.main(["--mode", "knn", *argv])
    with pytest.raises(SystemExit):
        serve.parser().parse_args(["--mode", "knn", *argv])


def _defined_public(mod) -> set:
    """A module's own public names: functions and classes defined in it, and
    its UPPER_CASE constants."""
    return {n for n, v in vars(mod).items() if not n.startswith("_") and (
        (n.isupper() and not callable(v)) or getattr(v, "__module__", None) == mod.__name__)}


@pytest.mark.parametrize("port_name,ref_name,extra", [
    ("repro_torch.runtime.sharding", "repro.runtime.sharding",
     {"NamedSharding", "P", "Sharded", "place"}),
    ("repro_torch.runtime.elastic", "repro.runtime.elastic", set()),
    ("repro_torch.launch.mesh", "repro.launch.mesh", set()),
])
def test_mesh_substrate_names_are_the_references(port_name, ref_name, extra):
    """The substrate on the mesh exports the reference's names (the port's
    PartitionSpec, NamedSharding and placement besides), each function
    taking the reference's parameters first, in its order."""
    import importlib
    import inspect

    port, ref = importlib.import_module(port_name), importlib.import_module(ref_name)
    assert set(port.__all__) == _defined_public(ref) | extra
    assert _defined_public(port) == set(port.__all__)
    for name in _defined_public(ref):
        want = getattr(ref, name)
        if inspect.isfunction(want):
            got = list(inspect.signature(getattr(port, name)).parameters)
            assert got[:len(inspect.signature(want).parameters)] == list(
                inspect.signature(want).parameters), name
    if hasattr(ref, "DEFAULT_RULES"):
        assert port.DEFAULT_RULES == ref.DEFAULT_RULES
