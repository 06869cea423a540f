"""Three-term roofline, the pure arithmetic:

    compute    = FLOPs / (chips * peak)
    memory     = bytes / (chips * hbm_bw)
    collective = wire_bytes / (chips * link_bw)

``peak`` is the bf16 tensor-core rate by default, as in the JAX package;
``peak="f32"`` takes the IEEE f32 rate the port's kernels run at (no
TF32). The bound a kernel's ``chip_smoke.py`` entry prints, ``bound_ms``,
is ``roofline_terms(ops, bytes, 0, 1, hw=H100_SXM, peak="f32").step_time_s``
in milliseconds.

Not ported, by nature: the JAX package's ``analyze_compiled`` and
``collective_bytes_from_hlo`` read the FLOPs, bytes and collectives of a
compiled XLA executable from its cost analysis and HLO text. A PyTorch
program that runs eagerly has no HLO; the port counts its work from the
shapes instead.
"""
from __future__ import annotations

import dataclasses

from repro_torch.roofline.hw import H100_SXM, HwSpec


@dataclasses.dataclass
class Roofline:
    chips: int
    hlo_flops: float
    hlo_bytes: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_flops_ratio: float
    collective_ops: dict
    step_time_s: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_terms(
    hlo_flops: float,
    hlo_bytes: float,
    wire_per_device: float,
    chips: int,
    model_flops: float = 0.0,
    hw: HwSpec = H100_SXM,
    peak: str = "bf16",
) -> Roofline:
    if peak not in ("bf16", "f32"):
        raise ValueError(f"peak must be 'bf16' or 'f32', got {peak!r}")
    rate = hw.peak_flops_bf16 if peak == "bf16" else hw.peak_flops_f32
    compute = hlo_flops / (chips * rate)
    memory = hlo_bytes / (chips * hw.hbm_bw)
    collective = wire_per_device / hw.link_bw  # == total/(chips*link_bw)
    terms = {"compute": compute, "memory": memory, "collective": collective}
    bottleneck = max(terms, key=terms.get)
    return Roofline(
        chips=chips,
        hlo_flops=hlo_flops,
        hlo_bytes=hlo_bytes,
        wire_bytes_per_device=wire_per_device,
        compute_s=compute,
        memory_s=memory,
        collective_s=collective,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_flops_ratio=(model_flops / hlo_flops) if hlo_flops else 0.0,
        collective_ops={},
        step_time_s=max(terms.values()),
    )
