"""The port's roofline arithmetic against the reference's, and the one
source of the card's constants: ``chip_smoke.py``'s ``bound_ms`` is the
roofline's step time at the f32 peak of ``H100_SXM``.

No number here is a measurement: the H100 constants are its data sheet's,
and the TPU numbers are a copy of the reference's ``TPU_V5E``, used only to
hold the two implementations of the same arithmetic equal.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import pathlib

import pytest
import torch

from repro.roofline import analysis as janalysis
from repro.roofline import hw as jhw
from repro_torch.roofline import H100_SXM, HwSpec, Roofline, roofline_terms

ROOT = pathlib.Path(__file__).resolve().parents[1]

CASES = [  # (flops, bytes, wire bytes a device, chips, model flops)
    (1.0e12, 5.0e9, 0.0, 1, 0.0),
    (3.3e15, 1.2e12, 4.0e9, 8, 2.0e15),
    (0.0, 8.2e9, 1.0e6, 4, 0.0),
    (7.0e9, 1.0, 9.0e10, 2, 7.0e9),
]


@pytest.mark.parametrize("case", CASES)
def test_terms_equal_the_references_field_for_field(case):
    tpu = HwSpec(**dataclasses.asdict(jhw.TPU_V5E), peak_flops_f32=1.0)
    got = roofline_terms(*case, hw=tpu)
    want = janalysis.roofline_terms(*case, hw=jhw.TPU_V5E)
    assert got.to_dict() == want.to_dict()
    assert [f.name for f in dataclasses.fields(Roofline)] == [
        f.name for f in dataclasses.fields(janalysis.Roofline)]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Smoke(torch, torch.device("cpu"))


@pytest.mark.parametrize("nbytes,ops", [
    (4.1e9, 3.1e10),  # the GIST f32 scan: bytes
    (4.1e6, 6.3e10),  # the int8 scan at m=64: operations
    (8.0e3, 0.0), (0.0, 5.0e5), (3.35e12, 67e12),  # a tie goes to bytes
])
def test_chip_smoke_bound_is_the_roofline_at_the_f32_peak(nbytes, ops):
    smoke = _smoke()
    assert (smoke.bw, smoke.flops) == (H100_SXM.hbm_bw, H100_SXM.peak_flops_f32)
    bound_ms, by = smoke.bound(nbytes, ops)
    r = roofline_terms(ops, nbytes, 0.0, 1, hw=H100_SXM, peak="f32")
    assert bound_ms == r.step_time_s * 1e3
    assert by == ("bytes" if r.memory_s >= r.compute_s else "operations")


def test_h100_constants_are_the_data_sheets():
    assert H100_SXM.hbm_bw == 3.35e12 and H100_SXM.peak_flops_f32 == 67e12
    assert H100_SXM.peak_flops_bf16 == 989e12 and H100_SXM.hbm_bytes == 80 * 10**9
    assert H100_SXM.link_bw == 450e9 and H100_SXM.tdp_watts == 700.0
    default = roofline_terms(1e12, 0.0, 0.0, 1)  # bf16 by default, as the reference
    assert default.compute_s == 1e12 / H100_SXM.peak_flops_bf16
    assert roofline_terms(1e12, 0.0, 0.0, 1, peak="f32").compute_s == 1e12 / 67e12
    with pytest.raises(ValueError, match="peak"):
        roofline_terms(1.0, 1.0, 0.0, 1, peak="tf32")
