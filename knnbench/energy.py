"""The card's energy over a window.

NVML's counter of the energy the card has used since the driver loaded
(``nvmlDeviceGetTotalEnergyConsumption``, millijoules), read through
``ctypes`` before and after the window. Where the counter cannot be read,
``nvidia-smi`` samples ``power.draw`` every 100 ms across the window and
the samples are integrated. The card's power limit is read beside it.
"""
from __future__ import annotations

import ctypes
import subprocess
import time


class _Nvml:
    def __init__(self, index: int):
        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        if self.lib.nvmlInit_v2() != 0:
            raise OSError("nvmlInit failed")
        self.handle = ctypes.c_void_p()
        if self.lib.nvmlDeviceGetHandleByIndex_v2(index, ctypes.byref(self.handle)) != 0:
            raise OSError("no NVML handle for the card")

    def energy_mj(self) -> int:
        e = ctypes.c_ulonglong()
        if self.lib.nvmlDeviceGetTotalEnergyConsumption(self.handle, ctypes.byref(e)) != 0:
            raise OSError("the energy counter cannot be read")
        return int(e.value)

    def power_limit_w(self) -> float | None:
        p = ctypes.c_uint()
        ok = self.lib.nvmlDeviceGetPowerManagementLimit(self.handle, ctypes.byref(p)) == 0
        return p.value / 1e3 if ok else None

    def close(self) -> None:
        self.lib.nvmlShutdown()


class EnergyMeter:
    """``start()`` before the window, ``stop()`` after it; then ``joules``
    (None where neither way reads the card) and ``power_limit_w``."""

    def __init__(self, index: int):
        self.index = index
        self.joules: float | None = None
        self.power_limit_w: float | None = None
        self.how: str | None = None
        self._nvml = self._smi = None
        self._e0 = self._t0 = None

    def start(self) -> None:
        try:
            self._nvml = _Nvml(self.index)
            self.power_limit_w = self._nvml.power_limit_w()
            self._e0 = self._nvml.energy_mj()
        except OSError:
            if self._nvml is not None:
                self._nvml.close()
            self._nvml = None
            self._start_smi()

    def _start_smi(self) -> None:
        try:
            self._smi = subprocess.Popen(
                ["nvidia-smi", "-i", str(self.index), "--query-gpu=power.draw,power.limit",
                 "--format=csv,noheader,nounits", "-lms", "100"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
            self._t0 = time.perf_counter()
        except OSError:
            self._smi = None

    def stop(self) -> None:
        if self._nvml is not None:
            try:
                self.joules = (self._nvml.energy_mj() - self._e0) / 1e3
                self.how = "nvml_energy_counter"
            finally:
                self._nvml.close()
                self._nvml = None
        elif self._smi is not None:
            seconds = time.perf_counter() - self._t0
            self._smi.terminate()
            out, _ = self._smi.communicate(timeout=30)
            self._smi = None
            rows = [line.split(",") for line in out.splitlines() if line.count(",") == 1]
            watts = [float(a) for a, _ in rows]
            if watts:
                self.joules = sum(watts) / len(watts) * seconds
                self.power_limit_w = float(rows[-1][1])
                self.how = "nvidia_smi_power_draw"
