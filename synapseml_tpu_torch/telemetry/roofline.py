"""Roofline auditor: counted bytes and flops of any step of the port.

The PyTorch port of the JAX package's ``telemetry/roofline.py``:

- :func:`capture` — the counterpart of XLA's cost analysis.  It runs the
  callable once under a counting dispatch mode: ``flops`` is
  ``torch.utils.flop_counter``'s count of matrix products, convolutions
  and attention (``matmul_flops``) plus one per element each pointwise op
  writes; ``bytes_accessed`` sums every dispatched op's operand
  and result bytes (XLA's definition for an unfused op; views move no
  bytes and are skipped), plus what each hand-written kernel reports
  for its launch (:func:`~synapseml_tpu_torch.kernels.launches.io_bytes`:
  the kernels are reached through ctypes, below the dispatcher);
  ``top_ops`` are the largest byte movers by aten op or kernel name.
  Unlike XLA's analysis it EXECUTES the callable, so callers hand it
  state that it may change (clones, a deep copy).
- :func:`roofline_block` — (bytes/sample, flops/sample, measured ms) →
  the canonical 6-key block, its bounds from the spec tables below; on a
  device with no table entry (the CPU) the bounds are null.
- :func:`paired_roofline` and :func:`audit` as in the JAX package.

The spec tables hold only the card the port runs on.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

__all__ = ["ROOFLINE_BLOCK_KEYS", "CHIP_PEAK_FLOPS", "CHIP_HBM_BW",
           "chip_lookup", "chip_peak_flops", "chip_hbm_bw", "capture",
           "roofline_block", "check_roofline_block", "paired_roofline",
           "audit"]

#: the canonical paired-block field set — schema-checked in the tests
ROOFLINE_BLOCK_KEYS = (
    "bytes_per_sample", "flops_per_sample", "compute_ms", "bandwidth_ms",
    "measured_ms", "frac_of_bandwidth_roofline",
)

#: peak dense bf16 flop/s by the name the CUDA device reports (NVIDIA's
#: H100 SXM data sheet, without sparsity, at its 700 W power limit; a
#: card set below 700 W runs slower under load)
CHIP_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}

#: device-memory bytes/s, same source and key
CHIP_HBM_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def _kind(device) -> str:
    """The name a device reports: ``torch.cuda.get_device_name`` for a
    card (a ``torch.device``, ``"cuda:N"`` or an index), else the
    object's ``device_kind``/``name`` attribute; ``""`` for the CPU."""
    if isinstance(device, (str, int)) or isinstance(device, torch.device):
        dev = torch.device(device) if not isinstance(device, int) \
            else torch.device("cuda", device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return ""
        return torch.cuda.get_device_name(dev)
    return str(getattr(device, "device_kind", "")
               or getattr(device, "name", "") or "")


def chip_lookup(device, table: Dict[str, float],
                default: Optional[float] = None) -> Optional[float]:
    """Longest-prefix device-name match into a spec table; ``default``
    (None = "unknown device, claim nothing") when no entry matches."""
    kind = _kind(device)
    best = None
    for name, val in table.items():
        if kind.startswith(name) and (best is None or len(name) > best[0]):
            best = (len(name), val)
    return best[1] if best else default


def chip_peak_flops(device, default: Optional[float] = None):
    return chip_lookup(device, CHIP_PEAK_FLOPS, default)


def chip_hbm_bw(device, default: Optional[float] = None):
    return chip_lookup(device, CHIP_HBM_BW, default)


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------

def _tensor_bytes(obj) -> int:
    total = 0
    stack = [obj]
    while stack:
        o = stack.pop()
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
        elif isinstance(o, dict):
            stack.extend(o.values())
    return total


#: ops that only relabel a tensor's metadata: no bytes move
_METADATA_OPS = frozenset({"_unsafe_view", "detach", "alias", "lift_fresh",
                           "_reshape_alias"})


def _numel(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel()
    if isinstance(obj, (list, tuple)):
        return sum(_numel(o) for o in obj)
    return 0


def _byte_mode():
    """A ``TorchDispatchMode`` that sums each op's operand and result
    bytes by op name, and the elements pointwise ops produce (one
    operation each, XLA's count for an elementwise op), built on first
    use: the mode class imports torch internals."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _ByteCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.by_op: Dict[str, int] = {}
            self.pointwise = 0

        def add(self, name: str, nbytes: int) -> None:
            if nbytes:
                self.by_op[name] = self.by_op.get(name, 0) + int(nbytes)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if not func.is_view and name not in _METADATA_OPS:
                self.add(name, _tensor_bytes(args) + _tensor_bytes(kwargs)
                         + _tensor_bytes(out))
                if torch.Tag.pointwise in func.tags:
                    self.pointwise += _numel(out)
            return out

    return _ByteCounter()


def capture(fn, *args, top_k: int = 8, **kw) -> Optional[Dict[str, Any]]:
    """Run ``fn(*args, **kw)`` once under the counting modes → ``{"flops",
    "matmul_flops", "bytes_accessed", "top_ops"}`` or None if the call
    raised — capture never breaks its caller.  ``matmul_flops`` is the
    flop counter's (products, convolutions, attention), ``flops`` adds
    one per element a pointwise op writes; ``top_ops`` lists ``{"name",
    "mbytes"}``, largest first.  The call executes: give it state it may
    change."""
    from torch.utils.flop_counter import FlopCounterMode
    from ..kernels import launches
    bytes_mode = _byte_mode()
    try:
        with FlopCounterMode(display=False) as flops, bytes_mode, \
                launches.reporting_bytes(bytes_mode.add):
            fn(*args, **kw)
        matmul_flops = float(flops.get_total_flops())
    except Exception:
        return None
    top = sorted(bytes_mode.by_op.items(), key=lambda kv: -kv[1])
    return {
        "flops": matmul_flops + bytes_mode.pointwise,
        "matmul_flops": matmul_flops,
        "bytes_accessed": float(sum(bytes_mode.by_op.values())),
        "top_ops": [{"name": n, "mbytes": b / 1e6}
                    for n, b in top[:max(1, top_k)]],
    }


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def roofline_block(bytes_per_sample: Optional[float],
                   flops_per_sample: Optional[float],
                   measured_ms: Optional[float],
                   device=None,
                   samples: float = 1.0) -> Dict[str, Optional[float]]:
    """The canonical 6-key block for one leg/config.

    ``measured_ms`` is the measured wall time of ``samples`` samples
    (one step, usually); compute/bandwidth bounds are for the same
    ``samples`` against the device's spec-sheet peaks — null on a
    device with no table entry, so no roofline fraction is invented
    where the bound is unknown."""
    peak = chip_peak_flops(device) if device is not None else None
    bw = chip_hbm_bw(device) if device is not None else None
    compute_ms = (samples * flops_per_sample / peak * 1e3
                  if peak and flops_per_sample else None)
    bandwidth_ms = (samples * bytes_per_sample / bw * 1e3
                    if bw and bytes_per_sample else None)
    frac = (bandwidth_ms / measured_ms
            if bandwidth_ms and measured_ms else None)
    return {
        "bytes_per_sample": bytes_per_sample,
        "flops_per_sample": flops_per_sample,
        "compute_ms": compute_ms,
        "bandwidth_ms": bandwidth_ms,
        "measured_ms": measured_ms,
        "frac_of_bandwidth_roofline": frac,
    }


def check_roofline_block(block: Any) -> None:
    """Schema guard: a paired roofline block is a dict carrying EXACTLY
    the canonical keys, each numeric or null."""
    if not isinstance(block, dict):
        raise ValueError(f"roofline block must be a dict, got "
                         f"{type(block).__name__}")
    missing = [key for key in ROOFLINE_BLOCK_KEYS if key not in block]
    if missing:
        raise ValueError(f"roofline block missing keys {missing}")
    bad = [key for key, v in block.items()
           if v is not None and not isinstance(v, (int, float))]
    if bad:
        raise ValueError(f"roofline block non-numeric fields {bad}")


def paired_roofline(leg: str, before: Dict[str, Optional[float]],
                    after: Dict[str, Optional[float]]) -> Dict[str, Any]:
    """``{leg}_roofline_before`` / ``{leg}_roofline_after`` pair, both
    sides schema-checked."""
    check_roofline_block(before)
    check_roofline_block(after)
    return {f"{leg}_roofline_before": dict(before),
            f"{leg}_roofline_after": dict(after)}


def audit(key: str, fn, *args, samples: float = 1.0,
          measured_ms: Optional[float] = None, device=None,
          **kw) -> Optional[Dict[str, Any]]:
    """One-call wrap of any step: capture its cost (running it once) and
    produce the per-sample roofline block plus the top byte movers.

    → ``{"key", "bytes_per_sample", "flops_per_sample",
    "arithmetic_intensity", "block", "top_ops"}`` or None when the
    capture failed or counted no bytes."""
    cost = capture(fn, *args, **kw)
    if cost is None or not cost.get("bytes_accessed"):
        return None
    bps = cost["bytes_accessed"] / max(samples, 1e-9)
    fps = cost["flops"] / max(samples, 1e-9)
    return {
        "key": key,
        "bytes_per_sample": bps,
        "flops_per_sample": fps,
        "arithmetic_intensity": (cost["flops"] / cost["bytes_accessed"]
                                 if cost["bytes_accessed"] else None),
        "block": roofline_block(bps, fps, measured_ms, device=device,
                                samples=samples),
        "top_ops": cost.get("top_ops", []),
    }
