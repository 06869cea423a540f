"""Quickstart on the PyTorch/CUDA port: exact kNN search through the
request-first API.

    PYTHONPATH=src python examples/torch_quickstart.py              # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The steps of ``examples/quickstart.py`` on ``repro_torch``: a clustered
corpus, every call through ONE entry point — ``ExactKNN.search(SearchRequest)``
on the card's kernels (``backend="cuda"``) — with the paper's two
configurations (FD-SQ latency / FQ-SD throughput) selected per request,
exactness checked against the brute-force oracle, and the per-request
options: k override, validity filter, the streamed store and the int8 tier
with its exactness certificate. ``--device cpu`` runs the kernels' plain
versions on the CPU.
"""
import argparse

import numpy as np
import torch

from repro_torch.api import SearchRequest
from repro_torch.core import ExactKNN, knn_oracle, pairwise_scores
from repro_torch.data import query_stream, vector_dataset


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card's kernels; raises where there is no "
                         "card) or cpu (the kernels' plain versions)")
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    args = ap.parse_args(argv)
    device = None if args.device == "cuda" else args.device
    n, d, k = args.n, args.d, args.k
    print(f"corpus: {n} x {d}, k={k}")
    x = vector_dataset(n, d, seed=0)
    queries = query_stream(x, 64, seed=1)

    engine = ExactKNN(k=k, metric="l2", n_partitions=8, backend="cuda",
                      device=device).fit(x)
    print(f"device: {engine.device}")

    # --- FD-SQ: latency path (paper fig. 2) -----------------------------
    res = engine.search(SearchRequest(queries=queries[0], mode_hint="fdsq"))
    print(f"FD-SQ 1-query: top-3 idx={res.indices[0, :3].cpu().numpy()} "
          f"dist={np.round(res.scores[0, :3].cpu().numpy(), 3)}")

    # --- FQ-SD: throughput path (paper fig. 1) --------------------------
    batch = engine.search(SearchRequest(queries=queries, mode_hint="fqsd"))
    print(f"FQ-SD batch of {len(queries)}: result {tuple(batch.scores.shape)} "
          f"(plan: {batch.plan.executor})")
    scores, indices = batch.scores.cpu().numpy(), batch.indices.cpu().numpy()

    # --- exactness vs brute force ---------------------------------------
    ref_s, ref_i = knn_oracle(pairwise_scores(torch.from_numpy(queries),
                                              torch.from_numpy(x)), k)
    np.testing.assert_allclose(scores, ref_s.numpy(), rtol=1e-4, atol=2e-3)
    recall = np.mean([len(set(indices[i]) & set(ref_i.numpy()[i])) / k
                      for i in range(len(queries))])
    print(f"exactness: scores allclose to oracle, recall@{k} = {recall:.3f}")

    # --- per-request k: no new engine needed ----------------------------
    res3 = engine.search(SearchRequest(queries=queries, k=3, mode_hint="fqsd"))
    np.testing.assert_allclose(res3.scores.cpu().numpy(), scores[:, :3], rtol=1e-6)
    print(f"per-request k=3: result {tuple(res3.scores.shape)} "
          f"== first 3 columns of the k={k} result")

    # --- per-request validity filter (runtime data, no new executable) --
    mask = np.ones(engine.n_ids, dtype=bool)
    mask[indices[0, 0]] = False  # ban query 0's best hit
    filtered = engine.search(SearchRequest(queries=queries[0], filter_mask=mask))
    assert int(filtered.indices[0, 0]) == int(indices[0, 1])
    print("filter_mask: banned row excluded, runner-up promoted")

    # --- streamed FQ-SD (dataset "larger than device memory") -----------
    from repro_torch.store import DatasetStore

    ooc = ExactKNN(k=k, backend="cuda", device=device).fit_store(
        DatasetStore.from_array(x, rows_per_shard=8192), resident=False)
    streamed = ooc.search(SearchRequest(queries=queries))
    np.testing.assert_allclose(streamed.scores.cpu().numpy(), scores, rtol=1e-4, atol=2e-3)
    print(f"FQ-SD host-streamed ({streamed.plan.executor}) == resident result")

    # --- the plans behind the calls above (planner -> executor registry) -
    print("execution plans (one physical config, many logical ones):")
    for p in engine.plans:
        print(f"  mode={p.mode:<14} executor={p.executor:<14} m={p.m:<3} "
              f"k={p.k:<3} chunk={p.chunk_rows} partitions={p.n_partitions}")

    # --- int8 tier: 1 B/elem scan + certified exact rescore -------------
    engine.enable_int8()
    r8 = engine.search(SearchRequest(queries=queries, tier="int8"))
    idx8 = r8.indices.cpu().numpy()
    recall8 = np.mean([len(set(idx8[i]) & set(ref_i.numpy()[i])) / k
                       for i in range(len(queries))])
    print(f"int8 scan + f32 rescore: recall@{k}={recall8:.3f}, "
          f"certified-exact rows: {r8.certified.float().mean().item():.0%}, "
          f"bytes/pass: {r8.stats['bytes_scanned'] / 2**20:.0f} MiB "
          f"(f32 pass: {batch.stats['bytes_scanned'] / 2**20:.0f} MiB)")


if __name__ == "__main__":
    main()
