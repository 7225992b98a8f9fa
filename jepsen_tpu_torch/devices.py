"""The device every entry point of the port runs on.

Counterpart of `jepsen_tpu/devices.py` (`default_devices`,
`accelerator_available`, `resolve_backend`): there the analysis backend
is whatever JAX platform answers; here it is one explicit
`torch.device`. The default is the GPU. The CPU is used only when the
caller names it (the tests do), never as a silent substitute for a
missing card.
"""

from __future__ import annotations

import torch


class DeviceUnavailable(RuntimeError):
    """CUDA was requested (or defaulted to) but torch sees no card."""


def resolve_device(requested: str | torch.device | None = None
                   ) -> torch.device:
    """`requested` (default "cuda") as a torch.device. Raises
    DeviceUnavailable when it names CUDA and no CUDA device is present,
    and ValueError for anything but cuda or cpu."""
    dev = torch.device("cuda" if requested is None else requested)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "no CUDA device is available (torch.cuda.is_available() is "
            "false); pass device 'cpu' to run on the CPU")
    return dev
