"""The mesh through the engine, the planner, the scheduler and the Router.

``ExactKNN(mesh=)`` of the port runs on logical CPU devices (``["cpu"] *
8``) and is held against the reference engine on the same mesh shape, run
once per module in a subprocess with eight host devices (this file, run as
a script, writes the reference's answers to an ``.npz``). The reference's
ring-streamed int8 runs outside ``compat.use_mesh``: under that context
mesh JAX 0.9 refuses the single-device arguments of its streamed step
(ROADMAP C). The rest is the port alone: ``adversarial_cases.QUANT_CASES``
through every mesh int8 executor against the port's single-device
streamed f32 oracle, mutations and masks with no new executable, the
scheduler's per-device accounting, ``Router.create(devices=)`` and the
planner's sharded routing (pure: held against the reference planner here).
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

K, N, D = 7, 3000, 40
F32_CASES = [(metric, mode, m) for metric in ("l2", "ip", "cos")
             for mode, m in (("fdsq", 1), ("fdsq", 8), ("fqsd", 8))]
INT8_CASES = ("fdsq-sharded-int8", "fqsd-sharded-int8", "fqsd-sharded-int8-streamed")


def rows(metric: str):
    """Integer rows for l2 and ip, rows of ±1 with power-of-two norms for
    cos (exact normalisation); duplicates planted; queries near rows."""
    rng = np.random.default_rng(3 + ("l2", "ip", "cos").index(metric))
    if metric == "cos":
        counts = rng.choice([1, 4, 16], N + 8)
        ranks = rng.random((N + 8, D)).argsort(1).argsort(1)
        a = ((ranks < counts[:, None]) * rng.choice([-1.0, 1.0], (N + 8, D)))
        x, q = a[:N].astype(np.float32), a[N:].astype(np.float32)
    else:
        x = rng.integers(-8, 9, (N, D)).astype(np.float32)
        q = rng.integers(-8, 9, (8, D)).astype(np.float32)
    x[2500] = x[11]
    q[0] = x[11]
    return q, x


def int8_rows():
    """Rows whose int8 scale is 1 (only the square root rounds)."""
    rng = np.random.default_rng(9)
    x = rng.integers(-127, 128, (N, D)).astype(np.float32)
    x[np.arange(N), rng.integers(0, D, N)] = 127.0
    q = rng.integers(-8, 9, (8, D)).astype(np.float32)
    q[0] = x[11]
    return q, x


def key(*parts) -> str:
    return "|".join(str(p) for p in parts)


# ----------------------------------------------------- the reference side
def _reference(out: str) -> None:
    import jax

    from repro import compat
    from repro.api import SearchRequest
    from repro.core import ExactKNN
    from repro.store import DatasetStore

    devices = jax.devices()
    assert len(devices) == 8, devices
    mesh = compat.make_mesh((4, 2), ("data", "model"))
    ring = compat.make_mesh((4,), ("data",), devices=devices[:4])
    res = {}

    def put(name, r):
        res[key(name, "s")] = np.asarray(r.topk.scores)
        res[key(name, "i")] = np.asarray(r.topk.indices)
        res[key(name, "exec")] = np.array(r.plan.executor)
        res[key(name, "mode")] = np.array(r.plan.mode)
        res[key(name, "bpd")] = np.asarray(r.stats.get("bytes_per_device", []), np.int64)
        res[key(name, "transfers")] = np.int64(r.stats.get("transfers", -1))

    with compat.use_mesh(mesh):
        for metric, mode, m in F32_CASES:
            q, x = rows(metric)
            eng = ExactKNN(k=K, metric=metric, mesh=mesh).fit(x)
            put(key(metric, mode, m), eng.search(SearchRequest(queries=q[:m], mode_hint=mode)))
        q, x = int8_rows()
        eng = ExactKNN(k=K, mesh=mesh)
        eng.fit_store(DatasetStore.from_array(x, row_mult=eng._row_mult(N),
                                              tiers=("f32", "int8")))
        put("fdsq-sharded-int8", eng.search(SearchRequest(queries=q, tier="int8")))
    # the ring-streamed int8 outside use_mesh (JAX 0.9 refuses it inside)
    eng = ExactKNN(k=K, mesh=ring, mesh_axes=("data",), device_budget_bytes=1)
    eng.fit_store(DatasetStore.from_array(x, rows_per_shard=384)).enable_int8()
    put("fqsd-sharded-int8", eng.search(SearchRequest(queries=q, tier="int8")))
    with tempfile.TemporaryDirectory() as tmp:
        eng = ExactKNN(k=K, mesh=ring, mesh_axes=("data",), device_budget_bytes=1)
        eng.fit_store(DatasetStore.from_array(x, rows_per_shard=512, directory=tmp))
        eng.enable_int8()
        put("fqsd-sharded-int8-streamed", eng.search(SearchRequest(queries=q, tier="int8")))
    np.savez(out, **res)


if __name__ == "__main__":
    _reference(sys.argv[1])
    sys.exit(0)


# ---------------------------------------------------------- the port side
import pytest  # noqa: E402
import torch  # noqa: E402
from adversarial_cases import QUANT_CASES  # noqa: E402
from test_torch_sharded import assert_same, exact_scores  # noqa: E402

from repro.core import planner as jplanner  # noqa: E402
from repro_torch import ExactKNN, SearchRequest  # noqa: E402
from repro_torch.api import Router  # noqa: E402
from repro_torch.core import planner as tplanner  # noqa: E402
from repro_torch.core.executors import cache_info  # noqa: E402
from repro_torch.core.fqsd import streamed_direct_scan  # noqa: E402
from repro_torch.core.mesh import make_mesh  # noqa: E402
from repro_torch.serving import AdaptiveScheduler  # noqa: E402
from repro_torch.store import DatasetStore  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
BACKENDS = ("torch", "cuda")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference engine's answers, computed once per module."""
    out = tmp_path_factory.mktemp("mesh_engine_ref") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(out)], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    return dict(np.load(out))


def _mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _check(name, got, ref, scores) -> None:
    assert got.plan.executor == str(ref[key(name, "exec")])
    assert got.plan.mode == str(ref[key(name, "mode")])
    assert_same(got.topk.scores, got.topk.indices, ref[key(name, "s")], ref[key(name, "i")],
                scores)
    assert list(got.stats.get("bytes_per_device", [])) == ref[key(name, "bpd")].tolist()
    assert got.stats.get("transfers", -1) == int(ref[key(name, "transfers")])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("metric,mode,m", F32_CASES)
def test_mesh_engine_f32_matches_the_reference(ref, metric, mode, m, backend):
    """fdsq-sharded / fqsd-sharded on a (4, 2) mesh, as the reference's."""
    q, x = rows(metric)
    eng = ExactKNN(k=K, metric=metric, backend=backend, device="cpu",
                   mesh=_mesh((4, 2))).fit(x)
    got = eng.search(SearchRequest(queries=q[:m], mode_hint=mode))
    norms = np.ones(N, np.float32)
    _check(key(metric, mode, m), got, ref, exact_scores(q[:m], x, norms, metric))
    assert eng.device == torch.device("cpu") and eng._ds.vectors.n_blocks == 8


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("executor", INT8_CASES)
def test_mesh_engine_int8_matches_the_reference(ref, executor, backend, tmp_path):
    q, x = int8_rows()
    if executor == "fdsq-sharded-int8":
        eng = ExactKNN(k=K, backend=backend, device="cpu", mesh=_mesh((4, 2)))
        store = DatasetStore.from_array(x, row_mult=eng._row_mult())
        store.ensure_tier("int8")
        eng.fit_store(store)
    else:
        kw = (dict(rows_per_shard=384) if executor == "fqsd-sharded-int8"
              else dict(rows_per_shard=512, directory=str(tmp_path)))
        eng = ExactKNN(k=K, backend=backend, device="cpu", mesh=_mesh((4,), ("data",)),
                       mesh_axes=("data",), device_budget_bytes=1)
        eng.fit_store(DatasetStore.from_array(x, **kw)).enable_int8()
    got = eng.search(SearchRequest(queries=q, tier="int8"))
    # every int8 answer is in the direct form: rank by the exact distance
    d = ((q.astype(np.float64)[:, None] - x.astype(np.float64)[None]) ** 2).sum(-1)
    _check(executor, got, ref, d)
    assert bool(got.certified.all())


# ---------------------------------------------- the port alone, QUANT_CASES
def _oracle(eng, q, k):
    """The port's streamed f32 direct-form oracle over the engine's store."""
    return streamed_direct_scan(eng._pad_queries(q), eng.store.shard_source("f32"), k)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("executor", INT8_CASES)
@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quant_cases_through_every_mesh_int8_executor(case, executor, backend, tmp_path):
    """Bit for bit against the single-device streamed f32 oracle, uncertified
    rows (the 12-decade case) taking the exact fallback; 384-row shards
    split some cases into 3, a count the 4-position ring does not divide."""
    q, x, k = QUANT_CASES[case]()
    mesh = _mesh((4,), ("data",))
    if executor == "fdsq-sharded-int8":
        eng = ExactKNN(k=k, backend=backend, device="cpu", mesh=mesh, mesh_axes=("data",))
        store = DatasetStore.from_array(x, row_mult=eng._row_mult())
        store.ensure_tier("int8")
        eng.fit_store(store)
    else:
        kw = (dict(rows_per_shard=384) if executor == "fqsd-sharded-int8"
              else dict(rows_per_shard=384, directory=str(tmp_path)))
        eng = ExactKNN(k=k, backend=backend, device="cpu", mesh=mesh, mesh_axes=("data",),
                       device_budget_bytes=1).fit_store(DatasetStore.from_array(x, **kw))
        eng.enable_int8()
    got = eng.search(SearchRequest(queries=q, tier="int8"))
    assert got.plan.executor == executor and got.tier == "int8"
    assert len(got.stats["bytes_per_device"]) == 4
    want = _oracle(eng, q, k)
    assert torch.equal(got.topk.scores, want.scores)
    assert torch.equal(got.topk.indices, want.indices)


@pytest.mark.parametrize("backend", BACKENDS)
def test_mesh_mutations_and_masks_add_no_executable(backend):
    """Upserts, deletes and a filter mask fold through the mesh executors
    with no new cache entry, every answer exact (float64 brute force over
    the live, eligible rows)."""
    rng = np.random.default_rng(23)
    x = rng.integers(-8, 9, (1024, 32)).astype(np.float32)
    q = rng.integers(-8, 9, (4, 32)).astype(np.float32)
    eng = ExactKNN(k=5, backend=backend, device="cpu", mesh=_mesh((4,), ("data",)),
                   mesh_axes=("data",))
    store = DatasetStore.from_array(x, row_mult=eng._row_mult())
    store.ensure_tier("int8")
    eng.fit_store(store)
    warm = eng.upsert(np.zeros((1, 32), np.float32))  # warm the delta path too
    for req in (SearchRequest(queries=q, tier="int8"), SearchRequest(queries=q),
                SearchRequest(queries=q, mode_hint="fqsd")):
        eng.search(req)
    eng.delete(warm)
    misses = cache_info()["misses"]
    ids = eng.upsert(q[:2] + 0.5)
    eng.delete([int(ids[0]), 3])
    mask = np.ones(eng.n_ids, bool)
    mask[[7, 11, int(ids[1])]] = False
    live = np.concatenate([x, np.zeros((1, 32), np.float32), q[:2] + 0.5])
    keep = mask.copy()
    keep[[int(warm[0]), int(ids[0]), 3]] = False
    gids = np.flatnonzero(keep)
    dist = ((q.astype(np.float64)[:, None] - live[keep].astype(np.float64)[None]) ** 2).sum(-1)
    order = np.argsort(dist, axis=1, kind="stable")[:, :5]
    for req in (SearchRequest(queries=q, tier="int8", filter_mask=mask),
                SearchRequest(queries=q, filter_mask=mask),
                SearchRequest(queries=q, mode_hint="fqsd", filter_mask=mask)):
        got = eng.search(req)
        assert got.plan.executor in ("fdsq-sharded-int8", "fdsq-sharded", "fqsd-sharded")
        assert got.topk.indices.tolist() == gids[order].tolist()
        assert np.array_equal(got.topk.scores.numpy(), np.take_along_axis(dist, order, 1))
    assert cache_info()["misses"] == misses


def test_scheduler_aggregates_per_device_bytes_and_phases():
    rng = np.random.default_rng(31)
    x = rng.standard_normal((1024, 24)).astype(np.float32)
    eng = ExactKNN(k=4, device="cpu", mesh=_mesh((4,), ("data",)), mesh_axes=("data",),
                   device_budget_bytes=1)
    eng.fit_store(DatasetStore.from_array(x, rows_per_shard=384)).enable_int8()
    sched = AdaptiveScheduler(eng, policy="throughput", int8_min_depth=4)
    reqs = [SearchRequest(queries=x[i], rid=i, arrival_s=0.0) for i in range(12)]
    for r in sched.serve(iter(reqs)):
        assert int(r.topk.indices[0]) == r.rid  # rows find themselves
    st = sched.stats()
    assert st["per_plan"]["fqsd-int8"]["executors"] == ["fqsd-sharded-int8"]
    assert st["per_plan"]["fqsd-int8"]["tier"] == ["int8"]
    assert len(st["bytes_per_device"]) == 4 and sum(st["bytes_per_device"]) > 0
    assert st["phase_ms"]["scan_ms"] >= 0.0


def test_router_places_collections_on_a_device_group():
    """devices= builds one ("data",) mesh per group (the identical object,
    so placed collections share executable-cache entries), lists the group
    in stats, and serves the mesh's int8 tier."""
    rng = np.random.default_rng(41)
    x = rng.standard_normal((1024, 48)).astype(np.float32)
    q = rng.standard_normal((2, 48)).astype(np.float32)
    router = Router()
    group = ["cpu"] * 4
    router.create("a", store=DatasetStore.from_array(x, row_mult=512), k=5, devices=group,
                  device="cpu")
    assert router.search("a", SearchRequest(queries=q, mode_hint="fdsq")).plan.executor \
        == "fdsq-sharded"
    assert router.stats()["collections"]["a"]["devices"] == group
    warm = cache_info()["misses"]
    router.create("b", store=DatasetStore.from_array(
        rng.standard_normal((1024, 48)).astype(np.float32), row_mult=512), k=5,
        devices=[torch.device("cpu")] * 4, device="cpu")
    assert router.engine("b").mesh is router.engine("a").mesh
    router.search("b", SearchRequest(queries=q, mode_hint="fdsq"))
    assert cache_info()["misses"] == warm
    ring = router.search("b", SearchRequest(queries=np.repeat(q, 3, 0), mode_hint="fqsd"))
    assert ring.plan.executor == "fqsd-sharded" and ring.topk.scores.shape == (6, 5)
    store = DatasetStore.from_array(x, row_mult=512)
    store.ensure_tier("int8")
    router.create("c", store=store, k=5, devices=group, device="cpu")
    r8 = router.search("c", SearchRequest(queries=q, tier="int8"))
    assert r8.plan.executor == "fdsq-sharded-int8"
    assert router.stats()["collections"]["c"]["bytes_scanned"]["int8"] > 0
    with pytest.raises(ValueError, match="either"):
        router.create("d", x, k=5, devices=group, mesh=router.engine("a").mesh)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA device"):
            router.create("e", x, k=5, devices=2)


# ------------------------------------------------------------- the planner
META = tplanner.DatasetMeta(padded_rows=2048, padded_dim=128, n_valid=2000)


def _both(meta_kw, mode, m=8, tier_meta=False, **cfg_kw):
    """The port's and the reference's plan of the same sharded request."""
    backend = cfg_kw.pop("backend", "torch")
    jbackend = {"torch": "xla", "cuda": "pallas"}[backend]
    tmeta_cls = tplanner.DatasetStoreMeta if tier_meta else tplanner.DatasetMeta
    jmeta_cls = jplanner.DatasetStoreMeta if tier_meta else jplanner.DatasetMeta
    base = dict(padded_rows=2048, padded_dim=128, n_valid=2000, sharded=True, **meta_kw)
    tp = tplanner.plan((m, 128), tmeta_cls(**base), tplanner.EngineConfig(
        k=4, backend=backend, **cfg_kw), mode)
    jp = jplanner.plan((m, 128), jmeta_cls(**base), jplanner.EngineConfig(
        k=4, backend=jbackend, **cfg_kw), mode)
    return tp, jp


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("meta_kw,tier_meta,mode,executor", [
    ({}, False, "fdsq", "fdsq-sharded"),
    ({}, False, "fqsd", "fqsd-sharded"),
    ({"tier": "int8"}, True, "fqsd", "fdsq-sharded-int8"),
    ({"tier": "int8", "resident": False, "rows_per_shard": 512}, True, "fqsd",
     "fqsd-sharded-int8"),
    ({"tier": "int8", "resident": False, "rows_per_shard": 512, "mmap": True}, True, "fqsd",
     "fqsd-sharded-int8-streamed"),
    ({"resident": False, "rows_per_shard": 512}, True, "fqsd", "fqsd-mmap-streamed"),
])
def test_planner_sharded_routing_matches_the_reference(meta_kw, tier_meta, mode, executor,
                                                       backend):
    tp, jp = _both(meta_kw, mode, tier_meta=tier_meta, backend=backend)
    assert tp.executor == jp.executor == executor
    assert tp.mode == jp.mode and tp.tier == jp.tier and tp.sharded == jp.sharded
    assert tp.chunk_rows == jp.chunk_rows and tp.cache_key()[1:] == jp.cache_key()[1:]
    assert executor in tplanner.PLANNABLE_EXECUTORS


def test_planner_sharded_flag_from_the_engine_config():
    cfg = tplanner.EngineConfig(k=4, sharded=True)
    assert tplanner.plan((1, 128), META, cfg, "fdsq").executor == "fdsq-sharded"
    p = tplanner.plan((8, 128), META, cfg, "fqsd")
    assert (p.executor, p.mode, p.sharded) == ("fqsd-sharded", "fqsd-sharded", True)
    assert tplanner.plan((8, 128), dataclasses.replace(META, sharded=True),
                         tplanner.EngineConfig(k=4), "fqsd").executor == "fqsd-sharded"
