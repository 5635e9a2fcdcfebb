"""Step-level training checkpoints.

The PyTorch port of the JAX package's ``core/checkpoint.py``, with its
on-disk layout: a directory of ``step_<10 digits>`` checkpoints, each an
``arrays.npz`` of the pytree's array leaves (``leaf_<i>``) and a pickled
``structure.pkl`` side-car holding only plain values:

- ``n_leaves``, ``metrics`` and ``others_bytes`` (the pickled non-array
  leaves by position), as the JAX package writes them;
- ``treedef_bytes``: always None here (a JAX treedef needs JAX to
  unpickle), so the JAX manager's ``restore_state_dict`` reads this
  package's directories positionally;
- ``torch_structure``: this package's own description of the pytree
  (dicts, lists, tuples, dataclasses; each leaf a tensor with its dtype
  and device, a numpy array or scalar, or a plain value), from which
  :meth:`CheckpointManager.restore` rebuilds it.

Leaves are numbered in ``jax.tree_util``'s order (dict keys sorted,
sequences in order, ``None`` no leaf; a dataclass's fields in order), so a
positional restore reads either package's ``arrays.npz``.  A bf16 tensor
goes to disk as its ``uint16`` bits; the side-car names its dtype.

Writes are atomic: the arrays and the side-car go into a temporary
directory that ``os.replace`` publishes, so a killed process never leaves
a half-written step where :meth:`all_steps` looks.  The
``checkpoint.save.pre_publish`` / ``checkpoint.save.post_publish`` kill
points and the ``checkpoint`` flight record mark the publish.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import pickle
import re
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..resilience.faults import get_faults

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d{10})$")


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic))


def _flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``tree`` → (leaves, structure) in ``jax.tree_util.tree_flatten``'s
    leaf order; ``structure`` is a nest of plain tuples."""
    leaves: List[Any] = []

    def walk(x):
        if x is None:
            return ("none",)
        if isinstance(x, dict):
            keys = sorted(x)
            return ("dict", keys, [walk(x[k]) for k in keys])
        if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
            return ("list" if isinstance(x, list) else "tuple",
                    [walk(v) for v in x])
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            names = [f.name for f in dataclasses.fields(x)]
            cls = type(x)
            return ("dataclass", f"{cls.__module__}:{cls.__qualname__}",
                    names, [walk(getattr(x, n)) for n in names])
        leaves.append(x)
        if isinstance(x, torch.Tensor):
            return ("tensor", str(x.dtype).replace("torch.", ""),
                    str(x.device))
        if isinstance(x, np.ndarray):
            return ("ndarray",)
        if isinstance(x, np.generic):
            return ("generic",)
        return ("value",)

    return leaves, walk(tree)


def _unflatten(structure: Any, leaves: List[Any], device=None) -> Any:
    """The inverse of :func:`_flatten`.  A ``tensor`` leaf that is not a
    tensor yet becomes one of its recorded dtype on ``device`` (None: the
    device it was saved from); numpy leaves stay numpy."""
    it = iter(leaves)

    def build(spec):
        kind = spec[0]
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(s) for k, s in zip(spec[1], spec[2])}
        if kind in ("list", "tuple"):
            vals = [build(s) for s in spec[1]]
            return vals if kind == "list" else tuple(vals)
        if kind == "dataclass":
            mod, qual = spec[1].split(":")
            cls = importlib.import_module(mod)
            for part in qual.split("."):
                cls = getattr(cls, part)
            vals = {n: build(s) for n, s in zip(spec[2], spec[3])}
            init = {f.name for f in dataclasses.fields(cls) if f.init}
            obj = cls(**{k: v for k, v in vals.items() if k in init})
            for k, v in vals.items():
                if k not in init:
                    object.__setattr__(obj, k, v)
            return obj
        leaf = next(it)
        if kind == "tensor" and not isinstance(leaf, torch.Tensor):
            return _to_tensor(leaf, getattr(torch, spec[1]),
                              torch.device(spec[2] if device is None
                                           else device))
        if kind == "generic" and isinstance(leaf, np.ndarray):
            return leaf[()]
        return leaf

    return build(structure)


def _to_host(x) -> np.ndarray:
    """An array leaf as the numpy array ``arrays.npz`` stores."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(x)


def _to_tensor(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """A stored leaf back as a tensor of ``dtype`` (bf16 from its bits)."""
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16 and a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16)).view(dtype)
    else:
        t = torch.from_numpy(a).to(dtype)
    return t.to(device)


class CheckpointManager:
    """Directory of ``step_<n>`` checkpoints with atomic writes.

    ``save(step, pytree, metrics)`` writes one; ``restore(step)`` rebuilds
    the pytree a manager of this package wrote; ``restore_state_dict(
    template, step)`` fills ``template``'s structure positionally from
    either package's checkpoint.  ``max_to_keep`` (0: all) prunes the
    oldest after each save."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = str(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    # -- discovery ---------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "arrays.npz")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    # -- save --------------------------------------------------------------
    def save(self, step: int, pytree: Any,
             metrics: Optional[Dict[str, float]] = None) -> str:
        """Write ``pytree`` as step ``step`` (device tensors are copied to
        the host) → the published directory."""
        leaves, structure = _flatten(pytree)
        arrays, others = {}, {}
        for i, leaf in enumerate(leaves):
            if _is_array(leaf):
                arrays[f"leaf_{i}"] = _to_host(leaf)
            else:
                others[i] = leaf
        final = self._step_dir(step)
        tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=self.directory)
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            # a SIGKILL here leaves only the temporary directory, which
            # discovery never lists
            get_faults().kill_point("checkpoint.save.pre_publish",
                                    step=step)
            with open(os.path.join(tmp, "structure.pkl"), "wb") as f:
                pickle.dump({"treedef_bytes": None,
                             "others_bytes": (pickle.dumps(others)
                                              if others else None),
                             "n_leaves": len(leaves),
                             "metrics": dict(metrics or {}),
                             "torch_structure": structure}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)          # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        from ..telemetry.flight import record as flight_record
        flight_record("checkpoint", step=int(step), path=final)
        get_faults().kill_point("checkpoint.save.post_publish", step=step)
        self._prune()
        return final

    def _prune(self) -> None:
        steps = self.all_steps()
        while self.max_to_keep and len(steps) > self.max_to_keep:
            victim = steps.pop(0)
            shutil.rmtree(self._step_dir(victim), ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def _load(self, step: Optional[int]):
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "structure.pkl"), "rb") as f:
            meta = pickle.load(f)
        leaves: List[Any] = [None] * meta["n_leaves"]
        with np.load(os.path.join(d, "arrays.npz"), allow_pickle=False) as z:
            for key in z.files:
                leaves[int(key.split("_", 1)[1])] = z[key]
        if meta.get("others_bytes"):
            for i, val in pickle.loads(meta["others_bytes"]).items():
                leaves[i] = val
        return leaves, meta

    def restore(self, step: Optional[int] = None, device=None) -> Any:
        """The pytree of step ``step`` (the newest by default), tensors on
        ``device`` (None: each on the device it was saved from).  A
        checkpoint the JAX package wrote carries no structure this
        package can read: restore it with :meth:`restore_state_dict`."""
        leaves, meta = self._load(step)
        structure = meta.get("torch_structure")
        if structure is None:
            raise TypeError(
                "checkpoint was saved without this package's structure "
                "(the JAX package's treedef needs JAX); restore with "
                "restore_state_dict(template)")
        return _unflatten(structure, leaves, device)

    def restore_state_dict(self, template: Any, step: Optional[int] = None,
                           device=None) -> Any:
        """Restore into the structure of ``template``: leaves are taken
        positionally from the checkpoint.  Where the template's leaf is a
        tensor, the saved values come back as a tensor of the template
        leaf's dtype on ``device`` (None: the template leaf's device); a
        bf16 leaf of this package comes back from its bits."""
        saved, meta = self._load(step)
        t_leaves, structure = _flatten(template)
        if len(saved) != len(t_leaves):
            raise ValueError(
                f"checkpoint has {len(saved)} leaves, template has "
                f"{len(t_leaves)}")
        out = []
        for s, t in zip(saved, t_leaves):
            if isinstance(t, torch.Tensor):
                s = _to_tensor(s, t.dtype, t.device if device is None
                               else torch.device(device))
            out.append(s)
        return _unflatten(structure, out)

    def metrics(self, step: int) -> Dict[str, float]:
        with open(os.path.join(self._step_dir(step), "structure.pkl"),
                  "rb") as f:
            return pickle.load(f)["metrics"]

