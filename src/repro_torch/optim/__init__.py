"""Optimizers, schedules, and gradient compression."""
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, apply_updates
from repro_torch.optim.compression import ErrorFeedback, compress_int8, decompress_int8
from repro_torch.optim.schedules import constant, cosine_schedule, wsd_schedule

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "apply_updates",
    "cosine_schedule", "wsd_schedule", "constant",
    "compress_int8", "decompress_int8", "ErrorFeedback",
]
