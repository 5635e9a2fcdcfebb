"""Codegen over the port's stages: the JAX package's codegen contracts
(``tests/test_codegen.py``) held over ``synapseml_tpu_torch.codegen``, and
parity with the JAX package's generators.

- Discovery over the port finds the same 175 stage names as the JAX
  package's ``discover_stages()``.
- Each stage's params (name, type, default) equal the JAX stage's, except
  ``device`` on the stages that run on the card and ``growthPolicy`` on
  the GBDT estimators (``CARD_PARAMS``).
- For every other stage the generated ``.pyi`` stub, R function, C#
  class and doc page text equal the JAX package's once the package prefix
  is swapped (``LLMTransformer`` excepted, below).

Generated files go to ``tmp_path``, never into the repo.
"""

import ast
import os
import re

import pytest

import synapseml_tpu.codegen as jx_cg
from synapseml_tpu.codegen import common as jx_common
from synapseml_tpu.codegen import docgen as jx_docgen
from synapseml_tpu.codegen import dotnetgen as jx_dotnet
from synapseml_tpu.codegen import pygen as jx_pygen
from synapseml_tpu.codegen import rgen as jx_rgen
from synapseml_tpu_torch.codegen import (discover_stages, generate_docs,
                                         generate_dotnet, generate_pyi,
                                         generate_r)
from synapseml_tpu_torch.codegen import common, docgen, dotnetgen, pygen, rgen
from synapseml_tpu_torch.codegen.discovery import stage_kind

JX, PT = "synapseml_tpu", "synapseml_tpu_torch"

#: stage → the params the port adds: ``device`` where the stage computes
#: on a device (default "cuda", RuntimeError without a card), and the
#: GBDT estimators' ``growthPolicy`` (depthwise or lossguide growth)
CARD_PARAMS = {"device"}
GBDT_ESTIMATORS = {"GBDTClassifier", "GBDTRegressor", "GBDTRanker"}

#: stages whose generated text differs for a reason other than a param
#: the port adds, → the artifacts that differ: LLMTransformer's ``bundle``
#: holds ``{model, tokenizer}`` in the port (a PyTorch LlamaModel carries
#: its weights) where the JAX stage holds ``{model, variables,
#: tokenizer}``, and the param docs (in R, C# and the doc page, not in
#: the stub) say so
TEXT_EXCEPTIONS = {"LLMTransformer": {"R", "C#", "doc"}}


def swap(text: str) -> str:
    """A JAX-generated text with the port's package prefix."""
    return text.replace(JX, PT)


@pytest.fixture(scope="module")
def stages():
    return discover_stages()


@pytest.fixture(scope="module")
def jx_stages():
    return jx_cg.discover_stages()


@pytest.fixture(scope="module")
def outputs(stages, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("codegen_port"))
    return {
        "pyi": generate_pyi(stages, os.path.join(d, "python")),
        "r": generate_r(stages, os.path.join(d, "R")),
        "cs": generate_dotnet(stages, os.path.join(d, "dotnet")),
        "docs": generate_docs(stages, os.path.join(d, "docs")),
    }


def _by_short(stages, prefix):
    return {q[len(prefix) + 1:]: c for q, c in stages.items()}


def _param_rows(cls, mod):
    return [(p.name, mod.lang_types(p), repr(p.default), p.doc)
            for p in mod.public_params(cls)]


def _added_params(name, jx_cls, pt_cls):
    """The params the port's stage adds to the JAX stage's, or None when
    the two differ in any other way."""
    a = _param_rows(jx_cls, jx_common)
    b = _param_rows(pt_cls, common)
    allowed = CARD_PARAMS | ({"growthPolicy"} if name in GBDT_ESTIMATORS
                             else set())
    b_kept = [r for r in b if r[0] not in allowed]
    if [r[:3] for r in a] != [r[:3] for r in b_kept]:
        return None
    return {r[0] for r in b} - {r[0] for r in a}


# -- parity with the JAX package's generators -------------------------------

class TestParity:
    def test_same_175_stage_names(self, stages, jx_stages):
        assert len(jx_stages) == 175
        assert set(_by_short(stages, PT)) == set(_by_short(jx_stages, JX))
        assert all(c.__module__.startswith(PT + ".")
                   for c in stages.values())

    def test_params_equal_but_the_named_ones(self, stages, jx_stages):
        port, ref = _by_short(stages, PT), _by_short(jx_stages, JX)
        differ = {}
        for q, cls in port.items():
            added = _added_params(cls.__name__, ref[q], cls)
            assert added is not None, f"{q}: params differ from the JAX stage"
            if added:
                differ[q] = added
        assert len(differ) == 42
        assert {n for a in differ.values() for n in a} == \
            CARD_PARAMS | {"growthPolicy"}
        assert {q.rsplit(".", 1)[1] for q, a in differ.items()
                if "growthPolicy" in a} == GBDT_ESTIMATORS
        # the stages that compute on a device default to the card
        for q in differ:
            assert port[q]().get_or_default("device") == "cuda", q

    def test_generated_text_equal_per_stage(self, stages, jx_stages):
        port, ref = _by_short(stages, PT), _by_short(jx_stages, JX)
        gens = [("pyi", pygen._class_stub, jx_pygen._class_stub),
                ("R", rgen._func, jx_rgen._func),
                ("C#", dotnetgen._class, jx_dotnet._class),
                ("doc", lambda c: docgen._page(c.__module__, [c]),
                 lambda c: jx_docgen._page(c.__module__, [c]))]
        checked, excepted = 0, set()
        for q, cls in sorted(port.items()):
            if _added_params(cls.__name__, ref[q], cls):
                continue
            for kind, mine, theirs in gens:
                if kind in TEXT_EXCEPTIONS.get(cls.__name__, ()):
                    excepted.add(cls.__name__)
                    assert mine(cls) != swap(theirs(ref[q]))
                    continue
                assert mine(cls) == swap(theirs(ref[q])), (kind, q)
            checked += 1
        assert checked == 175 - 42
        assert excepted == set(TEXT_EXCEPTIONS)

    def test_whole_files_equal_where_no_stage_differs(self, stages,
                                                      jx_stages, outputs,
                                                      tmp_path):
        """Generated files of the modules whose every stage is one of the
        equal ones, the docs index and the C# runtime base: the same file
        names, the same text."""
        port, ref = _by_short(stages, PT), _by_short(jx_stages, JX)
        odd = {port[q].__module__[len(PT) + 1:] for q in port
               if _added_params(port[q].__name__, ref[q], port[q])
               or port[q].__name__ in TEXT_EXCEPTIONS}
        # the stubs' common root is the package's own directory
        skip = {os.path.join(*m.split(".")) + ".pyi" for m in odd}
        skip |= {m.replace(".", "_") + ext for m in odd
                 for ext in (".R", ".cs", ".md")}
        d = str(tmp_path)
        theirs = {
            "pyi": jx_cg.generate_pyi(jx_stages, os.path.join(d, "python")),
            "r": jx_cg.generate_r(jx_stages, os.path.join(d, "R")),
            "cs": jx_cg.generate_dotnet(jx_stages, os.path.join(d, "dotnet")),
            "docs": jx_cg.generate_docs(jx_stages, os.path.join(d, "docs")),
        }
        compared = 0
        for kind, paths in outputs.items():
            root = os.path.commonpath(paths)
            jroot = os.path.commonpath(theirs[kind])
            mine = {os.path.relpath(p, root).replace(PT, JX): p
                    for p in paths}
            ref_files = {os.path.relpath(p, jroot): p for p in theirs[kind]}
            assert set(mine) == set(ref_files), kind
            for rel in sorted(set(mine) - skip):
                assert open(mine[rel]).read() == \
                    swap(open(ref_files[rel]).read()), (kind, rel)
                compared += 1
        assert compared > 100


class TestPrefix:
    """The package prefix is stated once (``common.PACKAGE``): file names,
    namespaces and the stub lookup of testgen strip it whole."""

    def test_file_names_carry_no_prefix(self, outputs):
        for kind in ("r", "cs", "docs"):
            for p in outputs[kind]:
                assert "synapseml" not in os.path.basename(p), p
        assert any(p.endswith(os.path.join("dotnet", "models_gbdt_"
                                           "estimators.cs"))
                   for p in outputs["cs"])

    def test_namespaces_and_headers(self, outputs):
        cs = open([p for p in outputs["cs"]
                   if p.endswith("models_gbdt_estimators.cs")][0]).read()
        assert "namespace SynapseMLTpu.Models.Gbdt.Estimators" in cs
        assert cs.startswith(f"// Auto-generated by {PT}.codegen")
        assert f'base("{PT}.models.gbdt.estimators", "GBDTClassifier")' in cs
        index = [p for p in outputs["docs"] if p.endswith("index.md")][0]
        assert open(index).read().startswith(f"# {PT} API reference")

    def test_short_module(self):
        assert common.short_module(f"{PT}.models.gbdt.estimators") == \
            "models.gbdt.estimators"
        assert common.short_module("other.pkg.mod") == "other.pkg.mod"


# -- the JAX package's tests/test_codegen.py, over the port -----------------

class TestDiscovery:
    def test_finds_the_main_stage_families(self, stages):
        names = {cls.__name__ for cls in stages.values()}
        for expected in ["GBDTClassifier", "OnlineSGDClassifier",
                         "ONNXModel", "DeepTextClassifier", "KNN", "SAR",
                         "TabularLIME", "ICETransformer", "HTTPTransformer",
                         "TextSentiment", "AnalyzeImage", "ImageTransformer",
                         "DoubleMLEstimator", "IsolationForest",
                         "FixedMiniBatchTransformer", "TuneHyperparameters"]:
            assert expected in names, f"{expected} not discovered"
        assert len(stages) > 120

    def test_kinds(self, stages):
        by_name = {c.__name__: c for c in stages.values()}
        assert stage_kind(by_name["GBDTClassifier"]) == "estimator"
        assert stage_kind(by_name["GBDTClassificationModel"]) == "model"
        assert stage_kind(by_name["HTTPTransformer"]) == "transformer"

    def test_private_bases_excluded(self, stages):
        assert all(not c.__name__.startswith("_")
                   for c in stages.values())


class TestPyi:
    def test_stubs_parse_as_python(self, outputs):
        for path in outputs["pyi"]:
            ast.parse(open(path).read(), filename=path)

    def test_estimator_has_fit_model_has_transform(self, outputs):
        path = [p for p in outputs["pyi"]
                if p.endswith("gbdt" + os.sep + "estimators.pyi")][0]
        tree = ast.parse(open(path).read())
        classes = {n.name: n for n in tree.body
                   if isinstance(n, ast.ClassDef)}
        clf_methods = {m.name for m in classes["GBDTClassifier"].body
                       if isinstance(m, ast.FunctionDef)}
        assert "fit" in clf_methods and "transform" not in clf_methods
        mdl_methods = {m.name
                       for m in classes["GBDTClassificationModel"].body
                       if isinstance(m, ast.FunctionDef)}
        assert "transform" in mdl_methods

    def test_param_defaults_rendered(self, outputs):
        path = [p for p in outputs["pyi"]
                if p.endswith("gbdt" + os.sep + "estimators.pyi")][0]
        src = open(path).read()
        assert "featuresCol: str = 'features'" in src
        assert "device: str = 'cuda'" in src


class TestR:
    def test_snake_cased_constructors_with_roxygen(self, outputs):
        joined = "\n".join(open(p).read() for p in outputs["r"])
        assert "sml_gbdt_classifier <- function(" in joined
        assert "#' @export" in joined
        assert "reticulate::import" in joined

    def test_r_defaults(self, outputs):
        joined = "\n".join(open(p).read() for p in outputs["r"])
        assert re.search(r"featuresCol = \"features\"", joined)
        assert "NULL" in joined


class TestDotnet:
    def test_classes_and_setters(self, outputs):
        joined = "\n".join(open(p).read() for p in outputs["cs"])
        assert "public class GBDTClassifier : PythonStage" in joined
        assert re.search(
            r"public GBDTClassifier SetFeaturesCol\(string value\)", joined)
        assert "namespace SynapseMLTpu." in joined


class TestDocs:
    def test_index_links_every_page(self, outputs):
        index = [p for p in outputs["docs"] if p.endswith("index.md")][0]
        content = open(index).read()
        pages = [p for p in outputs["docs"] if not p.endswith("index.md")]
        assert len(re.findall(r"\]\(", content)) == len(pages)

    def test_param_table(self, outputs):
        page = [p for p in outputs["docs"]
                if p.endswith("models_gbdt_estimators.md")][0]
        content = open(page).read()
        assert "| param | type | default | doc |" in content
        assert "`featuresCol`" in content


class TestValidators:
    def test_all_generated_artifacts_validate(self, stages, outputs):
        from synapseml_tpu_torch.codegen import validate_all
        counts = validate_all(outputs, stages)
        assert counts["pyi"] == len(outputs["pyi"])
        assert counts["r"] == len(stages)
        assert counts["cs"] == len(stages)

    def test_broken_pyi_fails(self, outputs, tmp_path):
        from synapseml_tpu_torch.codegen.validate import validate_pyi
        bad = tmp_path / "bad.pyi"
        bad.write_text(open(outputs["pyi"][0]).read() + "\ndef broken(:\n")
        with pytest.raises(SyntaxError):
            validate_pyi([str(bad)])

    def test_r_renamed_arg_fails(self, stages, outputs, tmp_path):
        from synapseml_tpu_torch.codegen.validate import (
            GeneratedArtifactError, validate_r)
        src = open(outputs["r"][0]).read()
        m = re.search(r"function\(([A-Za-z0-9_]+) =", src)
        broken = src.replace(f"function({m.group(1)} =",
                             "function(wrongName =", 1)
        bad = tmp_path / "bad.R"
        bad.write_text(broken)
        with pytest.raises(GeneratedArtifactError, match="args"):
            validate_r([str(bad)], stages)

    def test_r_unbalanced_fails(self, stages, outputs, tmp_path):
        from synapseml_tpu_torch.codegen.validate import (
            GeneratedArtifactError, validate_r)
        bad = tmp_path / "bad.R"
        bad.write_text(open(outputs["r"][0]).read() + "\nf <- function( {\n")
        with pytest.raises(GeneratedArtifactError):
            validate_r([str(bad)], stages)

    def test_cs_missing_setter_fails(self, stages, outputs, tmp_path):
        from synapseml_tpu_torch.codegen.validate import (
            GeneratedArtifactError, validate_dotnet)
        broken_paths = []
        removed = False
        for p in outputs["cs"]:
            src = open(p).read()
            if not removed:
                m = re.search(r"        public [A-Za-z0-9_]+ Set[^\n]*\n",
                              src)
                if m:
                    src = src.replace(m.group(0), "", 1)
                    removed = True
            q = tmp_path / os.path.basename(p)
            q.write_text(src)
            broken_paths.append(str(q))
        assert removed
        with pytest.raises(GeneratedArtifactError, match="missing setter"):
            validate_dotnet(broken_paths, stages)

    def test_cs_runtime_base_required(self, stages, outputs, tmp_path):
        from synapseml_tpu_torch.codegen.validate import (
            GeneratedArtifactError, validate_dotnet)
        no_base = [p for p in outputs["cs"]
                   if not p.endswith("PythonStage.cs")]
        with pytest.raises(GeneratedArtifactError, match="PythonStage"):
            validate_dotnet(no_base, stages)


class TestMechanicalTestgen:
    """pytest files emitted from the port's stage metadata and executed;
    a stub-vs-class drift makes the generated tests fail."""

    @pytest.fixture(scope="class")
    def gen_suite(self, stages, outputs, tmp_path_factory):
        from synapseml_tpu_torch.codegen import generate_pytests
        d = tmp_path_factory.mktemp("gen_tests")
        paths = generate_pytests(stages, outputs["pyi"], str(d))
        return str(d), paths

    def test_emits_one_file_per_module(self, stages, gen_suite):
        _, paths = gen_suite
        modules = {cls.__module__ for cls in stages.values()}
        assert len(paths) == len(modules)
        # file names carry the module path inside the package, not the
        # package prefix
        assert all(os.path.basename(p).startswith("test_gen_")
                   and PT not in os.path.basename(p) for p in paths)

    def test_generated_suite_passes(self, gen_suite):
        import subprocess
        import sys
        d, paths = gen_suite
        for p in paths:
            compile(open(p).read(), p, "exec")
        subset = [p for p in paths
                  if p.endswith(("models_gbdt_estimators.py",
                                 "ops_stages.py", "explainers_lime.py",
                                 "services_text.py"))]
        assert len(subset) == 4, paths[:3]
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        r = subprocess.run(
            [sys.executable, "-m", "pytest", *subset, "-q", "-x",
             "-p", "no:cacheprovider", "-p", "no:xdist"],
            capture_output=True, text=True, timeout=900, cwd=root,
            env={**os.environ, "PYTHONPATH": root})
        assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-2000:]

    def test_generated_suite_catches_stub_drift(self, stages, outputs,
                                                tmp_path):
        import subprocess
        import sys

        from synapseml_tpu_torch.codegen import generate_pytests
        stub_dir = tmp_path / "stubs"
        stub_dir.mkdir()
        broken_paths = []
        broke = False
        for p in outputs["pyi"]:
            rel = p.split(os.sep + "python" + os.sep, 1)[1]
            q = stub_dir / rel
            q.parent.mkdir(parents=True, exist_ok=True)
            src = open(p).read()
            if not broke and p.endswith("gbdt" + os.sep + "estimators.pyi"):
                assert "featuresCol" in src
                src = src.replace("featuresCol", "featuresColRenamed")
                broke = True
            q.write_text(src)
            broken_paths.append(str(q))
        assert broke
        d = tmp_path / "gen"
        gen_paths = generate_pytests(stages, broken_paths, str(d))
        target = [p for p in gen_paths if "gbdt_estimators" in p]
        assert target
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        r = subprocess.run(
            [sys.executable, "-m", "pytest", *target, "-q",
             "-p", "no:cacheprovider", "-p", "no:xdist"],
            capture_output=True, text=True, timeout=900, cwd=root,
            env={**os.environ, "PYTHONPATH": root})
        assert r.returncode != 0
        assert "drifted" in r.stdout
