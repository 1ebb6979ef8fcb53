"""The card's energy, from NVML through ``ctypes``.

:class:`Energy` reads the card's total-energy counter
(``nvmlDeviceGetTotalEnergyConsumption``, millijoules since the driver
loaded).  Where the card refuses the counter it integrates
``nvmlDeviceGetPowerUsage`` sampled at 20 Hz by a thread instead, and
says so in ``source``.  The card is found by its UUID, so the NVML
index need not match CUDA's."""

from __future__ import annotations

import ctypes
import threading
import time

__all__ = ["Energy"]


class _Sampler(threading.Thread):
    """Integrates the power reading (trapezoids) at 20 Hz."""

    def __init__(self, read) -> None:
        super().__init__(daemon=True)
        self._read = read
        self._stop_evt = threading.Event()
        self._lock = threading.Lock()
        self.joules = 0.0

    def run(self) -> None:
        t0, p0 = time.perf_counter(), self._read()
        while not self._stop_evt.wait(0.05):
            t1, p1 = time.perf_counter(), self._read()
            with self._lock:
                self.joules += 0.5 * (p0 + p1) * (t1 - t0)
            t0, p0 = t1, p1

    def total(self) -> float:
        with self._lock:
            return self.joules

    def stop(self) -> None:
        self._stop_evt.set()
        self.join()


class Energy:
    def __init__(self, uuid: str | None = None, index: int = 0) -> None:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
        handle_p = ctypes.POINTER(ctypes.c_void_p)
        for name, args in (
                ("nvmlInit_v2", []), ("nvmlShutdown", []),
                ("nvmlDeviceGetHandleByUUID", [ctypes.c_char_p, handle_p]),
                ("nvmlDeviceGetHandleByIndex_v2", [ctypes.c_uint, handle_p]),
                ("nvmlDeviceGetTotalEnergyConsumption",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]),
                ("nvmlDeviceGetPowerUsage",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)])):
            fn = getattr(nvml, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        self._nvml = nvml
        self._check(nvml.nvmlInit_v2(), "nvmlInit")
        self._handle = ctypes.c_void_p()
        if uuid:
            rc = self._nvml.nvmlDeviceGetHandleByUUID(
                uuid.encode(), ctypes.byref(self._handle))
        else:
            rc = 1
        if rc != 0:
            self._check(self._nvml.nvmlDeviceGetHandleByIndex_v2(
                index, ctypes.byref(self._handle)), "handle by index")
        self._sampler = None
        self.source = "nvmlDeviceGetTotalEnergyConsumption"
        try:
            self._counter()
        except RuntimeError as exc:
            self.source = (f"power sampled at 20 Hz (the energy counter "
                           f"was refused: {exc})")
            self._sampler = _Sampler(self._power)
            self._sampler.start()

    @staticmethod
    def _check(rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"NVML {what} returned {rc}")

    def _counter(self) -> float:
        mj = ctypes.c_ulonglong()
        self._check(self._nvml.nvmlDeviceGetTotalEnergyConsumption(
            self._handle, ctypes.byref(mj)), "total energy")
        return mj.value / 1e3

    def _power(self) -> float:
        mw = ctypes.c_uint()
        self._check(self._nvml.nvmlDeviceGetPowerUsage(
            self._handle, ctypes.byref(mw)), "power usage")
        return mw.value / 1e3

    def joules(self) -> float:
        """The card's energy so far, in joules (from an arbitrary
        origin)."""
        if self._sampler is not None:
            return self._sampler.total()
        return self._counter()

    def close(self) -> None:
        if self._sampler is not None:
            self._sampler.stop()
        self._nvml.nvmlShutdown()
