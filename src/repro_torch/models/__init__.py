"""The model substrate: the LM (layers, transformer), the recommenders
(recsys), MeshGraphNet (gnn) and its neighbour sampler (sampler)."""
