"""Device resolution for the PyTorch port.

Every entry point takes a ``device`` argument that defaults to ``"cuda"``.
There is no fallback: a caller that wants the CPU says ``device="cpu"``,
and asking for the card where there is none raises instead of quietly
running somewhere else.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``"cuda"`` / ``"cuda:N"`` / ``"cpu"`` → :class:`torch.device`.

    Raises ``RuntimeError`` for a CUDA device when no card is present and
    ``ValueError`` for any other device type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but no CUDA device is available; "
                "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: 'cuda' or "
                         "'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
