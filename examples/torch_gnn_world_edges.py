"""MeshGraphNet world-edge construction with the exact-kNN engine, on the
PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_gnn_world_edges.py              # the card
    PYTHONPATH=src python examples/torch_gnn_world_edges.py --device cpu

The steps of ``examples/gnn_world_edges.py`` on ``repro_torch``.
MeshGraphNet (arXiv:2010.03409) adds "world edges" between mesh nodes that
are CLOSE IN SPACE but far on the mesh (collision handling). That proximity
search is exactly the paper's problem: for every node, find its k nearest
nodes in world space. The two node embeddings (parameter space and world
space) are two named collections in one ``api.Router`` on the card's
kernels (``backend="cuda"``); both searches are ``SearchRequest``s, then one
MeshGraphNet forward runs on the combined mesh+world graph.
``--device cpu`` runs the kernels' plain versions and the model on the
CPU; ``--n`` sets the number of mesh nodes.
"""
import argparse

import numpy as np
import torch

from repro_torch.api import Router, SearchRequest
from repro_torch.models import gnn as G


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card's kernels; raises where there is no "
                         "card) or cpu (the kernels' plain versions)")
    ap.add_argument("--n", type=int, default=2_000)
    args = ap.parse_args(argv)
    device = None if args.device == "cuda" else args.device

    rng = np.random.default_rng(0)
    n = args.n  # cloth-like 2D mesh folded in 3D
    u = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    world = np.stack(  # fold the sheet so distant mesh nodes nearly touch
        [u[:, 0], np.abs(u[:, 1] - 0.5), np.sin(4 * np.pi * u[:, 1]) * 0.05],
        axis=1).astype(np.float32)

    # two collections, one router: same rows, two embedding spaces
    k_mesh, k_world = 8, 4
    router = Router()
    router.create("mesh-params", u, k=k_mesh + 1, backend="cuda", device=device)
    router.create("world", world, k=k_world + 1, backend="cuda", device=device)

    # mesh edges: 8-NN in PARAMETER space (the regular mesh)
    mesh_nn = router.search(
        "mesh-params", SearchRequest(queries=u, mode_hint="fqsd")).topk
    mesh_src = np.repeat(np.arange(n), k_mesh)
    mesh_dst = mesh_nn.indices[:, 1:].cpu().numpy().reshape(-1)  # skip self

    # world edges: kNN in WORLD space, keep pairs that are far on the mesh
    world_nn = router.search(
        "world", SearchRequest(queries=world, mode_hint="fqsd")).topk
    w_src = np.repeat(np.arange(n), k_world)
    w_dst = world_nn.indices[:, 1:].cpu().numpy().reshape(-1)
    mesh_gap = np.linalg.norm(u[w_src] - u[w_dst], axis=1)
    keep = mesh_gap > 0.25  # near in world, far on mesh = collision pair
    w_src, w_dst = w_src[keep], w_dst[keep]
    print(f"mesh edges: {len(mesh_src)}, world (collision) edges: {len(w_src)} "
          f"(exact kNN over {n} nodes, both searches)")
    cache = router.cache_info()
    print(f"router collections: {router.collections()}  "
          f"shared executable cache misses={cache['misses']}")

    senders = np.concatenate([mesh_src, w_src]).astype(np.int32)
    receivers = np.concatenate([mesh_dst, w_dst]).astype(np.int32)
    rel = world[senders] - world[receivers]
    edges = np.concatenate(
        [rel, np.linalg.norm(rel, axis=1, keepdims=True)], axis=1).astype(np.float32)

    cfg = G.GNNConfig(name="mgn-demo", n_layers=5, d_hidden=32,
                      d_node_in=3, d_edge_in=4, d_out=3)
    params = G.init(torch.Generator().manual_seed(0), cfg, device)
    dev = params["decoder"][0]["w"].device
    graph = {k: torch.from_numpy(v).to(dev) for k, v in (
        ("nodes", world), ("edges", edges), ("senders", senders), ("receivers", receivers))}
    with torch.no_grad():
        pred = G.apply(params, cfg, graph)
    finite = bool(torch.isfinite(pred).all())
    print(f"MeshGraphNet forward on mesh+world graph: output {tuple(pred.shape)}, "
          f"finite={finite}")
    return finite


if __name__ == "__main__":
    main()
