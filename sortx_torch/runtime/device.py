"""Device discovery, selection and sync.

Port of ``sortx/runtime/device.py`` (the reference's ``DeviceUtils`` /
``Device``, ``Adl/Adl.h:71-155``, ``Adl/Adl.inl:38-105``): pick a
device by platform and index, query its compute units and memory,
synchronise it, and count the bytes of live ``Buffer``s with a leak
check at teardown (``Adl/Adl.inl:102``).

Platforms: ``"gpu"`` (a CUDA card, ``cuda:<device_idx>``), ``"cpu"``
(the tensors' plain PyTorch versions, as the tests run), and ``"auto"``,
which is the GPU and raises without one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from ..utils.log import Channel, log, log_error

__all__ = ["DeviceConfig", "SortxDevice", "allocate_device", "device_count"]


@dataclasses.dataclass
class DeviceConfig:
    """Analog of DeviceUtils::Config (Adl/Adl.h:74-96)."""

    platform: str = "auto"  # "gpu" | "cpu" | "auto" (= "gpu")
    device_idx: int = 0


class SortxDevice:
    """A selected device with introspection and memory accounting."""

    def __init__(self, torch_device: torch.device, platform: str):
        self.torch_device = torch.device(torch_device)
        self.platform = platform
        # analog of Device::m_memoryUsage (AdlCL.inl:408)
        self.memory_usage = 0
        self._live_buffers = 0

    @property
    def is_cuda(self) -> bool:
        return self.torch_device.type == "cuda"

    # ---- introspection (Adl/Adl.inl:38-71, AdlCL.inl:704-760) ----
    @property
    def n_cores(self) -> int:
        """Compute-unit count (getNCUs analog): the card's SMs, or the
        host's cores for the CPU."""
        if self.is_cuda:
            return torch.cuda.get_device_properties(
                self.torch_device).multi_processor_count
        return os.cpu_count() or 1

    @property
    def name(self) -> str:
        if self.is_cuda:
            return torch.cuda.get_device_name(self.torch_device)
        return "cpu"

    def memory_stats(self) -> dict:
        """The caching allocator's counters (``torch.cuda.memory_stats``)
        and the card's ``bytes_limit`` / ``bytes_free``
        (``torch.cuda.mem_get_info``); empty for the CPU."""
        if not self.is_cuda:
            return {}
        free, total = torch.cuda.mem_get_info(self.torch_device)
        stats = dict(torch.cuda.memory_stats(self.torch_device))
        stats.update(bytes_limit=total, bytes_free=free)
        return stats

    @property
    def hbm_bytes(self) -> Optional[int]:
        return self.memory_stats().get("bytes_limit")

    # ---- sync (DeviceUtils::waitForCompletion, Adl/Adl.h:104-108) ----
    def wait_for_completion(self, *tensors) -> None:
        """Wait for all work queued on this device (the tensors passed,
        if any, are on it)."""
        if self.is_cuda:
            torch.cuda.synchronize(self.torch_device)

    # ---- accounting hooks used by runtime.buffer.Buffer ----
    def _on_alloc(self, nbytes: int) -> None:
        self.memory_usage += nbytes
        self._live_buffers += 1

    def _on_free(self, nbytes: int) -> None:
        self.memory_usage -= nbytes
        self._live_buffers -= 1

    def check_leaks(self) -> None:
        """Teardown leak assert (Adl/Adl.inl:102: ADLASSERT(used==0))."""
        if self.memory_usage != 0:
            log_error(
                f"device teardown with {self.memory_usage} bytes in "
                f"{self._live_buffers} live buffers")
            raise RuntimeError(
                f"sortx buffer leak: {self.memory_usage} bytes still "
                f"allocated")

    def __repr__(self):
        return f"SortxDevice({self.name}, platform={self.platform})"


def _platform(platform: str) -> str:
    if platform not in ("auto", "gpu", "cpu"):
        raise ValueError(f"platform must be auto|gpu|cpu, got {platform!r}")
    return "gpu" if platform == "auto" else platform


def device_count(platform: str = "auto") -> int:
    """Analog of DeviceUtils::getNDevices (Adl/Adl.h:113-116)."""
    if _platform(platform) == "cpu":
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def allocate_device(config: DeviceConfig | None = None) -> SortxDevice:
    """Analog of DeviceUtils::allocate (Adl/Adl.inl:73-98).

    ``"auto"`` and ``"gpu"`` take CUDA card ``device_idx`` and raise if
    there is none; ``"cpu"`` is the host.
    """
    config = config or DeviceConfig()
    platform = _platform(config.platform)
    n = device_count(platform)
    if platform == "gpu" and n == 0:
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "False); pass DeviceConfig(platform='cpu') for "
                           "the host")
    if not 0 <= config.device_idx < n:
        raise IndexError(
            f"device_idx {config.device_idx} out of range "
            f"({n} {platform} devices)")
    dev = SortxDevice(torch.device("cuda", config.device_idx)
                      if platform == "gpu" else torch.device("cpu"),
                      platform)
    log(f"allocated {dev!r}", Channel.DEVICE)
    return dev
