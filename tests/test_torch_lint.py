"""Boundaries of the PyTorch port: it imports no JAX, no flax, no msgpack
and nothing of the JAX package, and its entry points never fall back to
the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "synapseml_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "synapseml_tpu")


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
            f"for m in {FORBIDDEN!r}:\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r} and sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_lint_covers_the_serving_plane():
    """The serving slice's packages and the msgpack reader are among the
    files both lint tests walk."""
    rel = {os.path.relpath(p, PKG) for p in _port_files()[1:]}
    for sub in ("serving", "telemetry", "resilience"):
        assert any(r.startswith(sub + os.sep) for r in rel), sub
    assert os.path.join("io", "msgpack.py") in rel
    for m in ("synapseml_tpu_torch.serving.server",
              "synapseml_tpu_torch.serving.llm",
              "synapseml_tpu_torch.telemetry.slo",
              "synapseml_tpu_torch.resilience.health",
              "synapseml_tpu_torch.io.msgpack",
              "synapseml_tpu_torch.models.llm.finetune"):
        assert m in _modules(), m


def test_lint_covers_the_onnx_and_image_slice():
    """The ONNX modules, the image package and the row guard's OOM part
    are among the files both lint tests walk."""
    mods = _modules()
    for m in ("protoparse", "graph", "zoo", "hub", "ops", "runner", "model"):
        assert f"synapseml_tpu_torch.models.onnx.{m}" in mods, m
    for m in ("ops", "stages", "superpixel"):
        assert f"synapseml_tpu_torch.image.{m}" in mods, m
    assert "synapseml_tpu_torch.models.onnx" in mods
    assert "synapseml_tpu_torch.image" in mods
    assert "synapseml_tpu_torch.resilience.rowguard" in mods


def test_lint_covers_the_pipeline_serving_slice():
    """The pipeline servers, the continuous client, the row guard, the
    retry policies, the verb logging and the CSV ingest are among the
    files both lint tests walk."""
    mods = _modules()
    for m in ("serving.server", "serving.continuous", "resilience.rowguard",
              "resilience.policy", "core.logging", "core.dataset",
              "core.pipeline", "native", "io.colstore"):
        assert f"synapseml_tpu_torch.{m}" in mods, m
    assert os.path.exists(os.path.join(PKG, "native", "loader.cpp"))


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


def test_llm_import_builds_no_kernel():
    """Importing the LLM modules builds nothing and loads no library: K3
    builds at its first launch on a card."""
    import importlib
    from synapseml_tpu_torch.kernels import _build
    for m in ("model", "paged_attn", "generate", "slots", "convert",
              "drafter", "kvtier"):
        importlib.import_module(f"synapseml_tpu_torch.models.llm.{m}")
    from synapseml_tpu_torch.models.llm import paged_attn
    assert paged_attn._kernels.cache_info().currsize == 0
    assert _build.load_library.cache_info().currsize == 0


def test_paged_attention_limits_come_from_the_build():
    """K3's rows per block and head-width limit are stated once, in the
    build's defines, which the wrapper reads and nvcc receives.  Rows past
    one block's spread over more blocks, so only the head width limits
    what the wrapper takes."""
    from synapseml_tpu_torch.kernels import _build
    from synapseml_tpu_torch.models.llm import paged_attn
    d = _build.DEFINES["paged_attn"]
    assert (paged_attn._MAX_ROWS, paged_attn._MAX_D) == (
        d["SML_PA_MAX_ROWS"], d["SML_PA_MAX_D"])
    assert max(paged_attn._HEAD_DIMS) <= d["SML_PA_MAX_D"]
    flags = _build._flags("paged_attn")
    assert f"-DSML_PA_MAX_ROWS={d['SML_PA_MAX_ROWS']}" in flags
    assert f"-DSML_PA_MAX_D={d['SML_PA_MAX_D']}" in flags
    src = (_build._PKG / _build.SOURCES["paged_attn"]).read_text()
    assert "kMaxRows = SML_PA_MAX_ROWS" in src
    assert "kMaxD = SML_PA_MAX_D" in src
    assert "blockIdx.z * kMaxRows" in src
    assert paged_attn.SPLIT_KEYS == d["SML_PA_SPLIT"]
    assert f"-DSML_PA_SPLIT={d['SML_PA_SPLIT']}" in flags
    assert "kSplit = SML_PA_SPLIT" in src
    with pytest.raises(ValueError):
        paged_attn.check_kernel_layout(8, 8, 2 * d["SML_PA_MAX_D"],
                                       torch.float32)
    paged_attn.check_kernel_layout(8, 8, d["SML_PA_MAX_D"], torch.float32)


@pytest.mark.parametrize("S", [1, 2, 4, 8, 32])
def test_split_workspace_at_the_engine_shapes(S):
    """The split kernel's workspace at the decode engine's shapes
    (Llama-3.2-1B heads, 16 slots x 2048 positions): ceil(T / C) chunks of
    the S * group query rows' max, sum and D accumulators per (slot, kv
    head), C read from the build."""
    from synapseml_tpu_torch.kernels import _build
    from synapseml_tpu_torch.models.llm import paged_attn
    C = _build.DEFINES["paged_attn"]["SML_PA_SPLIT"]
    B, H, KV, D, T = 16, 32, 8, 64, 2048
    shape = paged_attn.split_workspace_shape(B, S, H, KV, D, T)
    assert shape == (B, KV, -(-T // C), S * H // KV, D + 2)
    assert shape[2] * C >= T > (shape[2] - 1) * C
    # a cache row that is no multiple of C still gets its last chunk
    assert paged_attn.split_workspace_shape(1, S, H, KV, D, C + 1)[2] == 2


def test_launch_counts_are_one_registry():
    """Every wrapper counts into ``kernels.launches``: one reset clears
    them all, and a count is kept per shape."""
    from synapseml_tpu_torch.kernels import launches
    launches.reset()
    launches.count("k_a", S=1)
    launches.count("k_a", S=1)
    launches.count("k_a", S=8)
    launches.count("k_ab", S=1)
    assert launches.total("k_a") == 3 and launches.total("k_ab") == 1
    assert launches.shapes("k_a") == {"k_a[S=1]": 2, "k_a[S=8]": 1}
    launches.reset()
    assert launches.BY_SHAPE == {} and launches.total("k_a") == 0
    for mod in ("models/gbdt/hist.py", "models/llm/paged_attn.py"):
        src = (Path(launches.__file__).parent.parent / mod).read_text()
        assert "launches.count(" in src and "LAUNCHES" not in src


def test_lint_covers_the_a8_stages():
    """The JAX-free stages over the GBDT (ROADMAP A8) are among the files
    both lint tests walk."""
    mods = _modules()
    for m in ("core.utils", "ops.featurize", "ops.train", "ops.stages",
              "ops.text", "ops.batchers", "automl.space", "automl.tune",
              "causal.dml", "exploratory.balance", "io.binary", "io.image",
              "io.http", "io.port_forward", "plot", "ops", "automl",
              "causal", "exploratory"):
        assert f"synapseml_tpu_torch.{m}" in mods, m
