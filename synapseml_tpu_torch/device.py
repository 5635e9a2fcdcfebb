"""Device resolution for the PyTorch port.

Every entry point takes a ``device`` argument that defaults to ``"cuda"``.
There is no fallback: a caller that wants the CPU says ``device="cpu"``,
and asking for the card where there is none raises instead of quietly
running somewhere else.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Union

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


_F32_NAMES = ("allow_tf32", "allow_bf16_reduced_precision_reduction",
              "allow_fp16_reduced_precision_reduction")
_f32_lock = threading.Lock()
_f32_depth = 0
_f32_saved: list = []


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """Products that sum in float32 at full precision: TF32 off for cuBLAS
    matmuls and cuDNN convolutions (PyTorch lets cuDNN take TF32 products
    by default), and no reduced-precision split-K sums for bf16/f16
    matmuls.  The flags are process-wide, so the blocks that overlap, on
    any threads, share one setting: the first to enter saves the
    caller's flags and turns them off, the last to leave restores them.
    Code outside every block sees them off while any block is open."""
    global _f32_depth, _f32_saved
    m = torch.backends.cuda.matmul
    with _f32_lock:
        if _f32_depth == 0:
            _f32_saved = ([getattr(m, n) for n in _F32_NAMES]
                          + [torch.backends.cudnn.allow_tf32])
            for n in _F32_NAMES:
                setattr(m, n, False)
            torch.backends.cudnn.allow_tf32 = False
        _f32_depth += 1
    try:
        yield
    finally:
        with _f32_lock:
            _f32_depth -= 1
            if _f32_depth == 0:
                for n, v in zip(_F32_NAMES, _f32_saved):
                    setattr(m, n, v)
                torch.backends.cudnn.allow_tf32 = _f32_saved[-1]
