"""Boundaries of the PyTorch port: it imports no JAX and nothing of the
JAX package, and its entry points never fall back to the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "synapseml_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "synapseml_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _port_files()[1:]:
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    return mods


def test_every_module_imports_without_jax():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'synapseml_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'synapseml_tpu') and "
            "sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path} imports {name}"


def test_no_kernel_built_at_import():
    """Importing the histogram module builds nothing and loads no
    library: the build happens at the first launch on a card."""
    from synapseml_tpu_torch.kernels import _build
    from synapseml_tpu_torch.models.gbdt import hist
    assert hist._kernels.cache_info().currsize == 0
    assert _build.load_library.cache_info().currsize == 0


def test_fit_without_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.models.gbdt.estimators import GBDTClassifier
    X = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    ds = Dataset({"features": list(X), "label": (X[:, 0] > 0) * 1.0})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GBDTClassifier(numIterations=1).fit(ds)


def test_device_resolution_has_no_fallback():
    from synapseml_tpu_torch.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
        with pytest.raises(RuntimeError):
            resolve_device()


def test_cuda_wrapper_refuses_cpu_fallback_inputs():
    """A wrapper given a CUDA-typed request it cannot serve raises; it
    never hands the work to the plain version."""
    from synapseml_tpu_torch.models.gbdt import hist
    with pytest.raises(ValueError):
        hist._check_smem(512, 64)
    with pytest.raises(ValueError):
        hist._check_smem(64, 0)


def test_kernel_limits_come_from_the_build():
    """The kernels' slot and shared-memory limits are stated once, in the
    build's defines, which the wrappers check against and nvcc receives."""
    from synapseml_tpu_torch.kernels import _build
    from synapseml_tpu_torch.models.gbdt import hist
    d = _build.DEFINES["gbdt_hist"]
    assert (hist._MAX_SLOTS, hist._MAX_SMEM) == (d["SML_MAX_SLOTS"],
                                                 d["SML_MAX_SMEM"])
    flags = _build._flags("gbdt_hist")
    assert f"-DSML_MAX_SLOTS={d['SML_MAX_SLOTS']}" in flags
    assert f"-DSML_MAX_SMEM={d['SML_MAX_SMEM']}" in flags
    src = (_build._PKG / _build.SOURCES["gbdt_hist"]).read_text()
    assert "kMaxSlots = SML_MAX_SLOTS" in src
    assert "kMaxSmem = SML_MAX_SMEM" in src
