"""Process start until the window opens: imports, the kernel library's
build or load, the data made on the card, the fit, the queries, the
warm-up of the cell's shapes (host clock)."""


def read(rec):
    return rec.setup_s
