"""The port's public import surface against the JAX package's.

Every public name a package ``__init__`` of the JAX package binds (its
``__all__`` where it has one, else its public attributes; submodules do
not count) resolves in the port's ``__init__`` of the same path, except
the names in ``EXCEPTIONS``: JAX/XLA constructs with no PyTorch meaning,
each with its reason and the port's counterpart.  Importing the port
initialises no CUDA context, and the port registers every stage the JAX
package registers, the service stages among them.
"""

import importlib
import os
import pkgutil
import subprocess
import sys
import types

import pytest

import synapseml_tpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (package, name) → why the port does not bind it, and its counterpart
EXCEPTIONS = {
    ("models.dl", "LOGICAL_RULES"):
        "flax logical-axis → mesh-axis rules for jit sharding; the port "
        "shards per rank by name: models.dl.transformer.shard_specs",
    ("models.llm", "LLM_LOGICAL_RULES"):
        "the decoder's flax logical-axis rules; the port's Megatron "
        "layout: models.llm.tp_shard_specs",
    ("models.llm", "engine_jit_cache_size"):
        "counts XLA executables in jax.jit caches; eager PyTorch compiles "
        "none: CompilePlane.snapshot()'s programs_warm and stalls",
    ("parallel", "make_mesh"):
        "builds a jax.sharding.Mesh over local devices; a mesh of the "
        "port is a process group: parallel.ProcessMesh, "
        "parallel.data_parallel_mesh",
    ("parallel", "batch_sharding"):
        "a jax NamedSharding of dim 0; the port splits a batch over "
        "ranks: parallel.shard_batch",
    ("parallel", "replicated"):
        "a replicated jax NamedSharding; a rank of the port holds the "
        "whole tensor: none needed",
    ("parallel", "local_mesh_devices"):
        "a mesh's jax devices in this process; one device per rank in the "
        "port: ProcessMesh.device",
    ("parallel", "shard_map_over"):
        "wraps jax.shard_map; the port's collectives are plain functions "
        "on a rank's tensor: parallel.psum and the rest",
}


def _jax_packages():
    names = [""]
    for info in pkgutil.walk_packages(synapseml_tpu.__path__,
                                      "synapseml_tpu."):
        if info.ispkg and not info.name.startswith("synapseml_tpu.native"):
            names.append(info.name[len("synapseml_tpu."):])
    return names


def _public_names(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in dir(mod) if not n.startswith("_")]
    return [n for n in names
            if not isinstance(getattr(mod, n, None), types.ModuleType)]


def test_packages_listed():
    pkgs = _jax_packages()
    for p in ("", "core", "io", "models.gbdt", "models.dl", "models.llm",
              "parallel", "telemetry", "services", "codegen"):
        assert p in pkgs, p


def test_every_jax_init_name_resolves_in_the_port():
    missing, used = [], set()
    for p in _jax_packages():
        ref = importlib.import_module("synapseml_tpu" + (p and "." + p))
        port = importlib.import_module("synapseml_tpu_torch"
                                       + (p and "." + p))
        for n in _public_names(ref):
            if (p, n) in EXCEPTIONS:
                used.add((p, n))
                assert not hasattr(port, n), (p, n, "listed but bound")
            elif not hasattr(port, n):
                missing.append((p, n))
    assert not missing, missing
    assert used == set(EXCEPTIONS)


def test_the_documented_imports():
    from synapseml_tpu_torch import Dataset, Pipeline  # noqa: F401
    from synapseml_tpu_torch.models import gbdt
    assert gbdt.LightGBMClassifier is gbdt.GBDTClassifier
    for a, b in (("LightGBMClassificationModel", "GBDTClassificationModel"),
                 ("LightGBMRegressor", "GBDTRegressor"),
                 ("LightGBMRegressionModel", "GBDTRegressionModel"),
                 ("LightGBMRanker", "GBDTRanker"),
                 ("LightGBMRankerModel", "GBDTRankerModel")):
        assert getattr(gbdt, a) is getattr(gbdt, b)
    from synapseml_tpu_torch.io import PowerBIResponseError, PowerBIWriter
    assert issubclass(PowerBIResponseError, RuntimeError)
    assert callable(PowerBIWriter.write)


def test_bound_names_are_the_port_modules_own():
    """A re-exported name is the object its port module defines."""
    import synapseml_tpu_torch as pt
    from synapseml_tpu_torch.core import pipeline
    from synapseml_tpu_torch.telemetry import autotune
    from synapseml_tpu_torch.models.llm import warmup
    assert pt.Pipeline is pipeline.Pipeline
    assert pt.telemetry.Autotuner is autotune.Autotuner
    assert pt.models.llm.ProgramSpec is warmup.ProgramSpec


@pytest.mark.parametrize("module", ["synapseml_tpu_torch",
                                    "synapseml_tpu_torch.services",
                                    "synapseml_tpu_torch.codegen"])
def test_import_initialises_no_cuda(module):
    code = ("import sys, torch\n"
            f"import {module}\n"
            "from synapseml_tpu_torch.kernels import _build\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert _build.load_library.cache_info().currsize == 0\n"
            "assert 'jax' not in sys.modules\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_every_module_has_its_port():
    """Every ``.py`` file of the JAX package has a counterpart at the same
    path in the port, but the two Pallas files (replaced by CUDA)."""
    ref = os.path.join(ROOT, "synapseml_tpu")
    missing = []
    for d, _, files in os.walk(ref):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), ref)
            if f.endswith(".py") and not os.path.exists(
                    os.path.join(ROOT, "synapseml_tpu_torch", rel)):
                missing.append(rel)
    assert sorted(missing) == [os.path.join("models", "gbdt",
                                            "pallas_hist.py"),
                               os.path.join("models", "llm",
                                            "pallas_attn.py")]


def test_registry_holds_every_jax_stage_with_the_services():
    from synapseml_tpu.codegen import discover_stages as jx_discover
    from synapseml_tpu_torch.codegen import discover_stages
    ref = {q[len("synapseml_tpu."):] for q in jx_discover()}
    port = {q[len("synapseml_tpu_torch."):] for q in discover_stages()}
    assert port == ref and len(port) == 175
    services = {q for q in port if q.startswith("services.")}
    assert len(services) == 51
