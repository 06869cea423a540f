"""The card's energy over the traced window (NVML's energy counter, or
nvidia-smi's power.draw integrated) over the queries answered in it. Also
reads ``joules_per_query.streamed``."""


def read(rec):
    if rec.energy_j is None or not rec.queries:
        return None
    return rec.energy_j / rec.queries
