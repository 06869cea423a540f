"""Hardware constants for the roofline model: the NVIDIA H100 SXM the port
runs on.

The rates are NVIDIA's data sheet for the H100 SXM part, dense (no
sparsity), at its full 700 W; a card set to a lower power limit runs below
them under load, so every measurement states the card's limit beside it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HwSpec:
    name: str
    peak_flops_bf16: float  # per chip, FLOP/s (tensor cores, dense)
    hbm_bw: float  # per chip, B/s
    link_bw: float  # per chip-to-chip link direction, B/s
    hbm_bytes: int  # per chip capacity
    tdp_watts: float  # for the energy model in benchmarks
    #: per chip, FLOP/s of IEEE f32 outside the tensor cores: the port's
    #: kernels run f32 without TF32, so their bounds use this peak
    peak_flops_f32: float

    @classmethod
    def from_device(cls, device=None, tdp_watts: float | None = None) -> "HwSpec":
        """H100_SXM with the name and memory size the card reports
        (``torch.cuda.get_device_properties``) and, if given, its power
        limit. The rates cannot be read from the card: they stay the data
        sheet's, so another card than an H100 raises."""
        import torch

        props = torch.cuda.get_device_properties(device)
        if "H100" not in props.name:
            raise ValueError(f"the rates of HwSpec are the H100 SXM's, not {props.name}'s")
        return dataclasses.replace(
            H100_SXM, name=props.name, hbm_bytes=int(props.total_memory),
            tdp_watts=H100_SXM.tdp_watts if tdp_watts is None else float(tdp_watts))


H100_SXM = HwSpec(
    name="NVIDIA H100 80GB HBM3",  # torch.cuda.get_device_name() of the SXM part
    peak_flops_bf16=989e12,  # data sheet: bf16 / fp16 tensor cores, dense
    hbm_bw=3.35e12,  # data sheet: HBM3, 3.35 TB/s
    link_bw=450e9,  # data sheet: NVLink 900 GB/s a card, 450 GB/s each way
    hbm_bytes=80 * 10**9,  # data sheet: 80 GB
    tdp_watts=700.0,  # data sheet: the SXM part's maximum power
    peak_flops_f32=67e12,  # data sheet: FP32 outside the tensor cores, 67 TFLOP/s
)
