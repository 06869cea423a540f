"""Dense passage retrieval for question answering on the PyTorch/CUDA port —
paper section 4.1 use case 2.

    PYTHONPATH=src python examples/torch_dense_retrieval.py              # the card
    PYTHONPATH=src python examples/torch_dense_retrieval.py --device cpu

The steps of ``examples/dense_retrieval.py`` on ``repro_torch``: the
two-tower item tower (``repro_torch.models.recsys``) stands in for the STAR
encoder and embeds a synthetic passage corpus into a named ``Router``
collection, searched by exact maximum inner product on the card's kernels
(``backend="cuda"``); a *bursty* stream of ``SearchRequest``s goes through
the AdaptiveScheduler: dense bursts route to an FQ-SD (throughput) plan,
the sparse trickle to FD-SQ (latency). Every dispatch goes
``Router.search -> ExactKNN.search``. ``--device cpu`` runs the encoder and
the kernels' plain versions on the CPU; ``--passages`` and ``--queries``
cut the sizes.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.api import Router
from repro_torch.models import recsys as R
from repro_torch.serving import AdaptiveScheduler, bursty_requests


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card's kernels; raises where there is no "
                         "card) or cpu (the kernels' plain versions)")
    ap.add_argument("--passages", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=256)
    args = ap.parse_args(argv)
    device = None if args.device == "cuda" else args.device

    # ----- "STAR" stand-in encoder: the two-tower item tower -------------
    cfg = R.RecsysConfig(
        name="encoder", kind="two_tower", table_sizes=(200_000,),
        embed_dim=64, tower_mlp=(256, 128), dtype=torch.float32,
    )
    params = R.init(torch.Generator().manual_seed(0), cfg, device)
    dev = params["embed"].device
    n_passages, n_queries = args.passages, args.queries
    passage_ids = torch.arange(n_passages, device=dev) % cfg.table_sizes[0]
    print(f"encoding {n_passages} passages (769-dim in the paper; "
          f"{cfg.tower_mlp[-1]}-dim here)...")
    with torch.no_grad():
        corpus = R._two_tower_embed(params, cfg, passage_ids, "item_tower").cpu().numpy()

    # queries: near-duplicates of passages (relevant passage = its source)
    rng = np.random.default_rng(1)
    src = rng.integers(0, n_passages, n_queries)
    qvecs = corpus[src] + 0.05 * rng.standard_normal((n_queries, corpus.shape[1])).astype(np.float32)

    # ----- exact MIPS retrieval through Router + adaptive scheduler -------
    router = Router()
    router.create("passages", corpus, k=10, metric="ip", n_partitions=8, backend="cuda",
                  device=device)
    server = AdaptiveScheduler(policy="adaptive", fqsd_min_depth=32,
                               router=router, collection="passages")

    t0 = time.perf_counter()
    hits = 0
    for res in server.serve(bursty_requests(qvecs)):
        hits += int(src[res.rid] in set(res.indices.tolist()))
    wall = time.perf_counter() - t0

    st = server.stats()
    print(f"served {st['served']} queries from collection "
          f"{st['collection']!r} in {wall:.2f}s "
          f"({n_queries / wall:.1f} q/s), mode_switches={st['mode_switches']}")
    for mode, r in st["per_plan"].items():
        print(f"  plan={mode:<5} n={r['count']:<5} p50={r['p50_ms']:.2f}ms "
              f"p99={r['p99_ms']:.2f}ms q/s={r['qps']:.1f} "
              f"executors={','.join(r['executors'])} tier={','.join(r['tier'])} "
              f"certified={r['certified_exact']:.2f}")
    rs = router.stats()["collections"]["passages"]
    print(f"  router: {rs['requests']} dispatches, "
          f"{rs['bytes_scanned']['f32'] / 2**30:.2f} GiB scanned (f32)")
    print(f"recall@10 of source passage: {hits / n_queries:.3f}")
    return hits / n_queries


if __name__ == "__main__":
    main()
