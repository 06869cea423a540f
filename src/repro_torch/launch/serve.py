"""Serving entry point: replay kNN retrieval traffic (the paper's workloads).

    PYTHONPATH=src python -m repro_torch.launch.serve --mode knn --n 20000 \
        --d 128 --k 10 --queries 200 --policy {latency,throughput,adaptive} \
        --collection passages [--device cpu]

The knn mode builds a named collection in an ``api.Router`` on the card's
kernels (``backend="cuda"``), replays a bursty arrival stream (dense bursts
alternating with a sparse trickle) of ``SearchRequest``s through the
AdaptiveScheduler — every dispatch goes
``Router.search -> ExactKNN.search(SearchRequest)`` — and reports, per
logical plan (fdsq / fqsd / fqsd-int8), the request count, p50/p99
latency, queries/s, executors, tier and certified fraction: the paper's
RQ3 trade-off as a runtime policy.

With ``--listen HOST:PORT`` the same collection is served over the
network instead of replayed: the asyncio HTTP/1.1 + WebSocket front end
(``repro_torch.server.KnnServer``) with per-tenant admission control and
continuous batching, every dispatch on one worker thread through the same
Router, scheduler and kernels. ``--max-inflight``, ``--tenant-qps`` and
``--queue-timeout-ms`` bound the live queue:

    PYTHONPATH=src python -m repro_torch.launch.serve --mode knn \
        --listen 127.0.0.1:8440 --collection passages \
        --max-inflight 512 --tenant-qps 100 --queue-timeout-ms 2000

It runs on the CUDA device and raises where there is none; ``--device cpu``
runs the kernels' plain versions on the CPU instead.
"""
from __future__ import annotations

import argparse
import math
import time


def _positive_int(text: str) -> int:
    """argparse type: int >= 1, rejected at parse time with a clear message
    (not deep inside the stream loop)."""
    try:
        v = int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected an integer, got {text!r}")
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def _nonneg_int(text: str) -> int:
    """argparse type: int >= 0 (retry budgets; 0 = no retries)."""
    try:
        v = int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected an integer, got {text!r}")
    if v < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {v}")
    return v


def _positive_float(text: str) -> float:
    """argparse type: finite float > 0 (rates, timeouts)."""
    try:
        v = float(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected a number, got {text!r}")
    if not (math.isfinite(v) and v > 0):
        raise argparse.ArgumentTypeError(
            f"must be a finite number > 0, got {text!r}")
    return v


def _listen_addr(text: str) -> tuple[str, int]:
    """argparse type: HOST:PORT (port in [0, 65535]; 0 = ephemeral),
    rejected at parse time, not at bind time."""
    host, sep, port_text = text.rpartition(":")
    if not sep or not host:
        raise argparse.ArgumentTypeError(
            f"expected HOST:PORT, got {text!r}")
    try:
        port = int(port_text)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"port must be an integer, got {port_text!r}")
    if not 0 <= port <= 65535:
        raise argparse.ArgumentTypeError(
            f"port must be in [0, 65535], got {port}")
    return host, port


def _shard_fraction(text: str) -> float:
    """argparse type: speculation trigger in [0, 1] (1 = no speculation)."""
    try:
        v = float(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected a float, got {text!r}")
    if not 0.0 <= v <= 1.0:
        raise argparse.ArgumentTypeError(
            f"must be a shard fraction in [0, 1], got {v}")
    return v


def _build_router(args):
    """Build the Router and the collection the replay serves, on the card's
    kernels, over ``vector_dataset(args.n, args.d, seed=0)``. Returns
    (router, x)."""
    from repro_torch.api import Router
    from repro_torch.data import vector_dataset
    from repro_torch.tuning import probe_cuda_capability

    if args.device == "cuda":
        # probe-once capability verdict, persisted in the per-device
        # autotune cache: a failure raises here, and every later cuda plan
        # on this device raises too (nothing falls back to plain ops). On
        # the CPU the caller asked for the plain versions: nothing to probe
        probe_cuda_capability()
    x = vector_dataset(args.n, args.d, seed=0)
    router = Router()
    engine_kw = dict(k=args.k, n_partitions=args.partitions, backend="cuda",
                     device=None if args.device == "cuda" else args.device,
                     prefetch_depth=args.prefetch_depth,
                     spec_trigger=args.spec_trigger,
                     max_retries=args.max_retries)
    if args.verify_on_open or args.compact_min_pending is not None:
        # write the corpus through the disk store and reopen it verified:
        # full CRC audit at open, plus CRC-on-read armed on every streamed
        # shard for the life of the server. A disk-backed store is also
        # what journals mutations and compacts, so --compact-min-pending
        # implies this path.
        import atexit
        import shutil
        import tempfile

        from repro_torch.core.engine import resolve_device
        from repro_torch.store import DatasetStore

        device = resolve_device(engine_kw["device"])
        tmp = tempfile.mkdtemp(prefix="knn-store-")
        # the store's mappings stay open for the life of the server
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
        written = DatasetStore.from_array(x, directory=tmp)
        if args.int8_depth is not None:
            written.ensure_tier("int8", device=device)
        written.close()
        store = DatasetStore.open(tmp, verify=True,
                                  verify_on_read=args.verify_on_open)
        if args.compact_min_pending is not None:
            # background compactor: fold delta + tombstones into a fresh
            # generation once this many rows are pending (atomic swap;
            # in-flight searches keep their pinned generation)
            store.auto_compact_pending = args.compact_min_pending
        router.create(args.collection, store=store, **engine_kw)
    else:
        router.create(args.collection, x, **engine_kw)
    if args.int8_depth is not None:
        router.engine(args.collection).enable_int8()
    return router, x


def report(sched, router, args, wall: float) -> None:
    """Print the replay's report: totals, health, streaming and pipeline
    counters, one line per plan, bytes per tier, the router's cache."""
    st = sched.stats()
    print(f"collection={st['collection']}  policy={st['policy']}  "
          f"served={st['served']} (wall {wall:.2f}s)  "
          f"mode_switches={st['mode_switches']}  "
          f"deadline_misses={st['deadline_misses']}  shed={st['shed']}")
    h, cb = st["health"], st["circuit_breaker"]
    print(f"  health: retries={h['retries']} "
          f"failed_shards={h['failed_shards']} degraded={h['degraded']} "
          f"slow_shards={h['slow_shards']}  "
          f"breaker: open={cb['open']} trips={cb['trips']} "
          f"probes={cb['probes']}")
    if st["transfers"]:
        depth = args.prefetch_depth if args.prefetch_depth else "tuned/2"
        print(f"  streamed: transfers={st['transfers']} "
              f"restarts={st['restarts']} "
              f"(prefetch depth {depth})")
    if "phase_ms" in st:
        ph, sp = st["phase_ms"], st["speculation"]
        print(f"  pipeline: scan={ph['scan_ms']:.1f}ms "
              f"gather={ph['gather_ms']:.1f}ms "
              f"rescore={ph['rescore_ms']:.1f}ms  speculation: "
              f"speculated={sp['rows_speculated']} "
              f"topped_up={sp['rows_topped_up']} "
              f"wasted={sp['rows_wasted']} "
              f"over {sp['dispatches']} dispatches")
    for mode, r in st["per_plan"].items():
        print(f"  plan={mode:<5} n={r['count']:<5} p50={r['p50_ms']:.2f}ms "
              f"p99={r['p99_ms']:.2f}ms q/s={r['qps']:.1f} "
              f"executors={','.join(r['executors'])} "
              f"tier={','.join(r['tier'])} "
              f"certified={r['certified_exact']:.2f}")
    gib = {t: b / 2**30 for t, b in st["bytes_scanned"].items() if b}
    if gib:
        print("  bytes scanned per tier: "
              + "  ".join(f"{t}={v:.2f}GiB" for t, v in gib.items()))
    rstats = router.stats()
    cache = rstats["executable_cache"]
    col = rstats["collections"][args.collection]
    print(f"  router: {col['requests']} dispatches over "
          f"{col['n_rows']} rows; shared executable cache "
          f"hits={cache['hits']} misses={cache['misses']} "
          f"evictions={cache['evictions']}")


def build_server(args):
    """The --listen path's one construction: :func:`_build_router`'s Router
    and collection behind a :class:`repro_torch.server.KnnServer` that binds
    ``args.listen`` when started (not yet listening). Returns (server, x)."""
    from repro_torch.server import KnnServer

    router, x = _build_router(args)
    host, port = args.listen
    server = KnnServer(
        router, host=host, port=port,
        policy="throughput" if args.fqsd else args.policy,
        fdsq_max_batch=args.fdsq_max_batch,
        fqsd_min_depth=args.fqsd_min_depth,
        int8_min_depth=args.int8_depth,
        max_inflight=args.max_inflight,
        tenant_qps=args.tenant_qps,
        queue_timeout_ms=args.queue_timeout_ms,
    )
    return server, x


def serve_http(args):
    """--listen path: the network front end over the same collection, until
    interrupted."""
    import asyncio

    server, _ = build_server(args)
    policy = server.schedulers[args.collection].policy

    async def run():
        async with server:
            bound_host, bound_port = server.address
            print(f"serving collection {args.collection!r} "
                  f"({args.n} x {args.d}) on http://{bound_host}:{bound_port} "
                  f"(policy={policy} max_inflight={args.max_inflight} "
                  f"tenant_qps={args.tenant_qps} "
                  f"queue_timeout_ms={args.queue_timeout_ms})", flush=True)
            print("endpoints: POST /v1/collections/"
                  f"{args.collection}/{{search,upsert,delete,compact}}  "
                  f"GET /v1/collections/{args.collection}/compact  "
                  "GET /healthz  GET /stats  WS /v1/stats/stream", flush=True)
            try:
                await server.serve_forever()
            except asyncio.CancelledError:
                pass

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        print("shutdown requested, draining")


def serve_knn(args):
    from repro_torch.data import query_stream
    from repro_torch.serving import AdaptiveScheduler, bursty_requests

    if args.listen is not None:
        serve_http(args)
        return
    policy = "throughput" if args.fqsd else args.policy
    router, x = _build_router(args)
    q = query_stream(x, args.queries, seed=1)
    sched = AdaptiveScheduler(
        policy=policy,
        fdsq_max_batch=args.fdsq_max_batch, fqsd_min_depth=args.fqsd_min_depth,
        int8_min_depth=args.int8_depth,
        router=router, collection=args.collection,
    )
    req_opts = {"allow_partial": True} if args.allow_partial else {}
    reqs = bursty_requests(q, args.burst_size, args.trickle, **req_opts)
    t0 = time.perf_counter()
    n_served = sum(1 for _ in sched.serve(reqs))
    wall = time.perf_counter() - t0
    report(sched, router, args, wall)
    assert n_served == args.queries
    return sched, router


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=["knn"], default="knn")
    ap.add_argument("--device", default="cuda",
                    help="device the collection lives on: cuda (the card's "
                         "kernels; raises where there is no card) or cpu "
                         "(the kernels' plain versions)")
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--partitions", type=int, default=8)
    ap.add_argument("--policy", choices=["latency", "throughput", "adaptive"],
                    default="latency")
    ap.add_argument("--collection", default="default",
                    help="collection name the corpus is registered under "
                         "in the api.Router (the serving front)")
    ap.add_argument("--fqsd", action="store_true",
                    help="deprecated alias for --policy throughput")
    ap.add_argument("--burst-size", type=int, default=64)
    ap.add_argument("--trickle", type=int, default=8)
    ap.add_argument("--fdsq-max-batch", type=int, default=4)
    ap.add_argument("--fqsd-min-depth", type=int, default=32)
    ap.add_argument("--int8-depth", type=int, default=None,
                    help="backlog depth at which the bandwidth-aware hook "
                         "routes FQ-SD batches to the int8 storage tier "
                         "(enables the tier; default: disabled)")
    ap.add_argument("--prefetch-depth", type=_positive_int, default=None,
                    help="streamed-scan double-buffer depth (>= 1; 2 = the "
                         "paper's two memory banks; deeper tolerates host "
                         "jitter at the cost of pinned host memory), handed "
                         "to every streamed executor. Default: the device's "
                         "tuned value, else 2")
    ap.add_argument("--spec-trigger", type=_shard_fraction, default=None,
                    help="streamed-int8 speculation trigger: shard fraction "
                         "in [0, 1] after which the candidate gather starts "
                         "on a background thread (1 disables speculation; "
                         "default: the device's tuned value, else 0.5). "
                         "Results are bit-identical at every setting")
    ap.add_argument("--verify-on-open", action="store_true",
                    help="round-trip the corpus through a disk store and "
                         "reopen it with a full CRC audit, arming per-read "
                         "CRC checks (ShardCorruptError on mismatch) for "
                         "every streamed shard")
    ap.add_argument("--allow-partial", action="store_true",
                    help="stamp allow_partial on every request: a shard "
                         "that stays unreadable after retries + quarantine "
                         "is skipped and the result is flagged partial "
                         "(default: strict — such a shard raises)")
    ap.add_argument("--compact-min-pending", type=_positive_int, default=None,
                    help="background-compact the collection's store once "
                         "this many rows are pending (delta rows + "
                         "tombstoned rows): folds them into a fresh shard "
                         "generation and swaps it in atomically without "
                         "blocking searches. Implies a disk-backed store "
                         "(like --verify-on-open)")
    ap.add_argument("--max-retries", type=_nonneg_int, default=None,
                    help="bounded retry budget (>= 0, exponential backoff) "
                         "for streamed shard reads / candidate gathers / "
                         "device transfers; 0 disables retry. Default: the "
                         "engine's default (2)")
    ap.add_argument("--listen", type=_listen_addr, default=None,
                    metavar="HOST:PORT",
                    help="serve the collection over HTTP instead of "
                         "replaying a synthetic stream: asyncio front end "
                         "with per-tenant admission control and continuous "
                         "batching (port 0 = ephemeral)")
    ap.add_argument("--max-inflight", type=_positive_int, default=512,
                    help="server-wide bound on admitted-but-unanswered "
                         "requests; arrivals past it get 429 + Retry-After "
                         "(--listen only)")
    ap.add_argument("--tenant-qps", type=_positive_float, default=None,
                    help="per-tenant sustained request rate over a 1s "
                         "sliding window; default: unlimited "
                         "(--listen only)")
    ap.add_argument("--queue-timeout-ms", type=_positive_float, default=None,
                    help="bound on time a request may wait in the live "
                         "queue before the server answers 503; default: "
                         "wait for dispatch (--listen only)")
    return ap


def main(argv=None):
    serve_knn(parser().parse_args(argv))


if __name__ == "__main__":
    main()
