"""Rows held in pinned host memory and streamed to the card for every
search: a ``DatasetStore`` of the mix's ``store`` arguments (its
``rows_per_shard``), searched through ``fit_store(..., resident=False)``
(``DoubleBufferedStream``)."""


def fit(cell, x, engine_kw: dict):
    from repro_torch import ExactKNN
    from repro_torch.store import DatasetStore

    store = DatasetStore.from_array(x, pin_memory=cell.dev.type == "cuda",
                                    **cell.mix.get("store", {}))
    return ExactKNN(**engine_kw).fit_store(store, resident=False)
