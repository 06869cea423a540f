"""Rows resident on the card: ``ExactKNN(...).fit(rows)``."""


def fit(cell, x, engine_kw: dict):
    from repro_torch import ExactKNN

    return ExactKNN(**engine_kw).fit(x)
