"""Rows row-sharded over the cell's cards and searched by the ring:
``Router().create(name, rows, devices=...)``, a one-axis ``("data",)``
mesh whose FQ-SD executor is ``fqsd_ring`` (``fqsd-sharded``).

The positions are cards 0 to chips - 1 where the cell's device is a card
and that many are present; otherwise the cell's device named chips times
(logical positions: the CPU tests, a test on one card). The benchmark's own
runs refuse a machine with fewer cards before they get here.

Over distinct cards the program must launch each kernel on the card of its
operands (``repro_torch.kernels.knn.kernel.on_card``): a program without
that guard launches into whichever card is current and answers part of
the queries from queues no kernel wrote, after minutes. Such a program is
refused at once.

The rows go to the Router from host memory. The engine's store keeps the
rows it is fitted from, padded (a second copy), and a collection that no
card holds whole lies in host memory; each card then receives its block
alone, and the first card is left its block and the ring's copies.
"""


def positions(cell):
    """``Router.create``'s ``devices``: a count of cards, or logical
    positions of the cell's device."""
    import torch

    chips = cell.work["chips"]
    if cell.dev.type == "cuda" and torch.cuda.device_count() >= chips:
        try:
            from repro_torch.kernels.knn.kernel import on_card  # noqa: F401
        except ImportError:
            raise RuntimeError("the program launches its kernels on the current card only "
                               "(no kernels.knn.kernel.on_card): the ring over distinct "
                               "cards cannot run") from None
        return chips
    return [cell.dev] * chips


def fit(cell, x, engine_kw: dict):
    from repro_torch.api.router import Router

    devices = positions(cell)
    return Router().create(cell.name, x.cpu(), devices=devices, **engine_kw)
