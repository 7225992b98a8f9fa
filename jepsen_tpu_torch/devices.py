"""The device every entry point of the port runs on, and the checkers'
analysis backend.

Counterpart of `jepsen_tpu/devices.py` (`default_devices`,
`accelerator_available`, `resolve_backend`): there the analysis backend
is whatever JAX platform answers; here it is an explicit
`torch.device`, and `default_devices` every visible card of its kind
(what a mesh spreads over). The default is the GPU. The CPU is used only when the
caller names it (the tests do), never as a silent substitute for a
missing card. Torch is imported where a device is resolved, so the
backend rules load without it.

A checker's `backend` keeps the reference's values (`auto`, `tpu`,
`cpu`, `race`), so one `JEPSEN_TPU_BACKEND` drives both packages:
`tpu` names the device path, which runs on the checker's `device`
(default cuda), and `cpu` the host oracles. `auto` is the device path
whether or not a card answers: the host oracle runs only when asked
for, and a default checker without a card raises DeviceUnavailable.
"""

from __future__ import annotations


class DeviceUnavailable(RuntimeError):
    """CUDA was requested (or defaulted to) but torch sees no card."""


def resolve_device(requested: str | torch.device | None = None
                   ) -> torch.device:
    """`requested` (default "cuda") as a torch.device. Raises
    DeviceUnavailable when it names CUDA and no CUDA device is present,
    and ValueError for anything but cuda or cpu."""
    import torch
    dev = torch.device("cuda" if requested is None else requested)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "no CUDA device is available (torch.cuda.is_available() is "
            "false); pass device 'cpu' to run on the CPU")
    return dev


def default_devices(requested: str | torch.device | None = None
                    ) -> list[torch.device]:
    """The devices a mesh spreads over (the reference's
    `default_devices`): every visible CUDA device, in order, as
    `cuda:k` — `CUDA_VISIBLE_DEVICES` restricts them — or just the one
    `requested` names when it carries an index (`cuda:1`), or `[cpu]`
    when it names the CPU. Raises DeviceUnavailable when CUDA is asked
    for (the default) and there is no card: never the CPU instead."""
    import torch
    dev = resolve_device(requested)
    if dev.type == "cpu" or dev.index is not None:
        return [dev]
    return [torch.device("cuda", k)
            for k in range(torch.cuda.device_count())]


#: The checker backends, the reference's names.
BACKENDS = ("auto", "tpu", "cpu", "race")


def resolve_backend(backend: str = "auto") -> str:
    """A checker's backend choice as "tpu" (the device path) or "cpu"
    (the host oracles). "race" resolves as "auto" here
    (`checker.Linearizable` races the two before resolving); "auto"
    takes JEPSEN_TPU_BACKEND when it names tpu or cpu, else the device
    path — never the oracle for want of a card (the reference resolves
    it by the hardware it finds). Anything else raises ValueError."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of "
                         f"{', '.join(BACKENDS)}")
    if backend == "race":
        backend = "auto"
    if backend != "auto":
        return backend
    from . import gates
    env = gates.get("JEPSEN_TPU_BACKEND")
    if env in ("tpu", "cpu"):
        return env
    return "tpu"
