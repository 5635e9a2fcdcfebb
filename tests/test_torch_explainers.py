"""The port's explainers (``synapseml_tpu_torch.explainers``) against the
JAX package's on the CPU.

The explained model is the same numpy function in both packages (a
logistic model, a vector sum, a token counter, a bright-quadrant score),
subclassed from each package's ``Transformer``; once it is a GBDT that
the JAX package fits and the port reads through its LightGBM text
interop.  The perturbations are drawn from the same
``np.random.default_rng(seed)`` in the same order, so the perturbed
inputs and the model's outputs are equal and only the solves differ:
JAX's f32 solves against torch's batched f32 solves.

Tolerances, against the scale of the reference's output (its largest
magnitude): LIME coefficients and r² within 1e-4 (reading: <= 5e-7).
Kernel SHAP values within 5e-2 (reading: 1.1e-3 to 2.7e-2).  SHAP pins
its empty and full coalitions with weight 1e6 beside unit-weight rows,
and the JAX package's float32 sums round the unit rows' terms against
the pinned rows': its solves land 1-4% of scale from the float64
solution of the same problem.  The port sums and solves in float64
(within 4e-8 of that solution), so the gap is the reference's rounding;
``test_batched_solvers_match_float64`` holds the port to float64 within
1e-6 on such a problem.  The efficiency sum ``sum(phi) = f(x) - f(empty)``
holds within 1e-4 of the outputs' scale in both packages (reading:
<= 7e-6 absolute).  The solvers alone, on well-conditioned problems:
least squares and lasso (200 ISTA steps) within 1e-4 of scale against
JAX (reading: <= 1e-6).
"""

import numpy as np
import pytest
import torch

import synapseml_tpu.explainers as JE
import synapseml_tpu_torch.explainers as TE
from synapseml_tpu import Dataset as JDataset
from synapseml_tpu import Transformer as JTransformer
from synapseml_tpu.image import slic_segments as j_slic
from synapseml_tpu_torch.core import Dataset as TDataset
from synapseml_tpu_torch.core import Transformer as TTransformer
from synapseml_tpu_torch.core.params import PyObjectParam
from synapseml_tpu_torch.image import slic_segments as t_slic
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

W_TAB = np.array([2.0, -3.0, 0.5])
LIME_TOL, SHAP_TOL = 1e-4, 5e-2


def _models(base):
    """The test models of one package (same numpy bodies in both)."""

    class Logistic(base):
        """P(1) = sigmoid(w . [a, b, c] + 0.25) as a 2-vector column."""

        def _transform(self, ds):
            x = np.stack([ds[c].astype(np.float64) for c in "abc"], 1)
            p = 1.0 / (1.0 + np.exp(-(x @ W_TAB + 0.25)))
            return ds.with_column("probability",
                                  [np.array([1 - v, v]) for v in p])

    class VectorLogistic(base):
        """Three class scores of a vector column."""

        def _transform(self, ds):
            m = np.stack([np.asarray(v, np.float64) for v in ds["features"]])
            z = np.stack([m[:, 0] + 2 * m[:, 2], -m[:, 1], m[:, 3] * 0.5], 1)
            e = np.exp(z - z.max(1, keepdims=True))
            return ds.with_column("probability",
                                  list(e / e.sum(1, keepdims=True)))

    class TokenCount(base):
        def _transform(self, ds):
            s = [str(t).split() for t in ds["text"]]
            return ds.with_column("score", np.array(
                [1.0 * ("good" in t) - 0.5 * ("bad" in t) + 0.01 * len(t)
                 for t in s]))

    class BrightQuadrant(base):
        def _transform(self, ds):
            out = [np.asarray(v, np.float64)[:16, :16].mean()
                   for v in ds["image"]]
            return ds.with_column("score", np.asarray(out))

    return {"tab": Logistic, "vec": VectorLogistic, "text": TokenCount,
            "image": BrightQuadrant}


JM, TM = _models(JTransformer), _models(TTransformer)


def _tab(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return {c: rng.normal(size=n) for c in "abc"}


def _vec(n=5, seed=1):
    rng = np.random.default_rng(seed)
    return {"features": list(rng.normal(size=(n, 4)))}


TEXTS = ["good movie with a bad ending", "bad plot", "a good good day out",
         "nothing here at all"]


def _images(n=2, seed=2):
    """Flat blocks plus mild noise: both packages' SLIC agree on them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = np.zeros((32, 32, 3), np.float32)
        for i in range(0, 32, 8):
            for j in range(0, 32, 8):
                img[i:i + 8, j:j + 8] = rng.uniform(0, 255, 3)
        out.append(img + rng.normal(0, 2, img.shape).astype(np.float32))
    return {"image": out}


def _case(kind, pkg):
    """(explainer, input Dataset) of one package for one case."""
    jax_side = pkg == "jax"
    E = JE if jax_side else TE
    D = JDataset if jax_side else TDataset
    M = JM if jax_side else TM
    kw = {} if jax_side else {"device": "cpu"}
    if kind in ("tab_lime", "tab_lime_lasso", "tab_shap"):
        bg = D(_tab(64, 9))
        if kind == "tab_shap":
            ex = E.TabularSHAP(M["tab"](), inputCols=list("abc"),
                               backgroundData=bg, numSamples=96, seed=3, **kw)
        else:
            ex = E.TabularLIME(M["tab"](), inputCols=list("abc"),
                               backgroundData=bg, numSamples=128, seed=3,
                               regularization=(0.01 if "lasso" in kind
                                               else 0.0), **kw)
        return ex, D(_tab())
    if kind in ("vec_lime", "vec_shap"):
        cls = E.VectorLIME if kind == "vec_lime" else E.VectorSHAP
        ex = cls(M["vec"](), inputCol="features", seed=4,
                 numSamples=96,
                 targetClasses=[0, 2], backgroundData=D(_vec(32, 7)), **kw)
        return ex, D(_vec())
    if kind in ("text_lime", "text_shap"):
        cls = E.TextLIME if kind == "text_lime" else E.TextSHAP
        ex = cls(M["text"](), inputCol="text", targetCol="score",
                 numSamples=64, seed=5, **kw)
        return ex, D({"text": np.array(TEXTS, dtype=object)})
    if kind in ("image_lime", "image_shap"):
        cls = E.ImageLIME if kind == "image_lime" else E.ImageSHAP
        ex = cls(M["image"](), inputCol="image", targetCol="score",
                 cellSize=8.0, modifier=40.0, numSamples=64, seed=6, **kw)
        return ex, D(_images())
    raise KeyError(kind)


KINDS = ("tab_lime", "tab_lime_lasso", "tab_shap", "vec_lime", "vec_shap",
         "text_lime", "text_shap", "image_lime", "image_shap")


@pytest.fixture(scope="module")
def explained():
    """Each case run once through each package."""
    out = {}
    for kind in KINDS:
        je, jds = _case(kind, "jax")
        te, tds = _case(kind, "torch")
        out[kind] = (je.transform(jds), te.transform(tds), te)
    return out


def _scale(a):
    return max(float(np.max(np.abs(a))), 1e-12)


@pytest.mark.parametrize("kind", KINDS)
def test_explanations_match_jax(explained, kind):
    want, got, _ = explained[kind]
    tol = SHAP_TOL if kind.endswith("shap") else LIME_TOL
    for w, g in zip(want["explanation"], got["explanation"]):
        assert g.shape == w.shape and g.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * _scale(w))
    for w, g in zip(want["r2"], got["r2"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    for col in ("tokens", "superpixels"):
        if col in want.columns:
            for w, g in zip(want[col], got[col]):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("kind", [k for k in KINDS if k.endswith("shap")])
def test_shap_efficiency_sum(explained, kind):
    """sum(phi) = f(x) - f(empty), whatever path each solver took."""
    want, got, ex = explained[kind]
    je, jds = _case(kind, "jax")
    fx = JE.common.extract_targets(je.model.transform(jds), je.targetCol,
                                   je.get("targetClasses"))
    for out in (want, got):
        for i, e in enumerate(out["explanation"]):
            base, phi = e[:, 0], e[:, 1:]
            np.testing.assert_allclose(phi.sum(1), fx[i] - base, rtol=0,
                                       atol=1e-4 * max(1.0, _scale(fx)))
    assert set(ex.timings) == {"perturb", "score", "solve"}


def test_superpixels_agree_on_the_test_images():
    """The image cases rest on equal segment maps."""
    for img in _images()["image"]:
        np.testing.assert_array_equal(
            t_slic(img, 8.0, 40.0, device="cpu"), j_slic(img, 8.0, 40.0))


@pytest.mark.parametrize("kind", ["average", "individual"])
def test_ice_matches_jax(kind):
    data = _tab(5)
    data["cat"] = np.array(["x", "y", "x", "z", "x"], dtype=object)
    outs = []
    for E, D, M in ((JE, JDataset, JM), (TE, TDataset, TM)):
        ice = E.ICETransformer(M["tab"](), numericFeatures=["a", "b"],
                               categoricalFeatures=["cat"], numSplits=4,
                               kind=kind)
        outs.append(ice.transform(D(dict(data))))
    want, got = outs
    assert want.columns == got.columns
    for c in want.columns:
        for w, g in zip(want[c], got[c]):
            if isinstance(w, str):
                assert w == g
            else:
                np.testing.assert_array_equal(np.asarray(g, dtype=object),
                                              np.asarray(w, dtype=object))


def _problems(B=8, S=40, D=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    y = (x @ rng.normal(size=D) + 0.1 * rng.normal(size=(B, S))
         ).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (B, S)).astype(np.float32)
    return x, y, w


@pytest.mark.parametrize("solver", ["ls", "lasso"])
def test_batched_solvers_match_jax(solver):
    x, y, w = _problems()
    if solver == "ls":
        got = TE.solvers.least_squares_batched(x, y, w, device="cpu")
        want = [JE.least_squares_regression(x[b], y[b], w[b])
                for b in range(len(x))]
    else:
        got = TE.solvers.lasso_batched(x, y, 0.05, w, device="cpu")
        want = [JE.lasso_regression(x[b], y[b], 0.05, w[b])
                for b in range(len(x))]
    for b, r in enumerate(want):
        for field in r._fields:
            ref = np.asarray(getattr(r, field))
            np.testing.assert_allclose(getattr(got, field)[b].numpy(), ref,
                                       rtol=0, atol=1e-4 * max(1.0,
                                                               _scale(ref)))
    one = (TE.least_squares_regression(x[0], y[0], w[0], device="cpu")
           if solver == "ls" else
           TE.lasso_regression(x[0], y[0], 0.05, w[0], device="cpu"))
    for field in one._fields:
        assert torch.equal(getattr(one, field), getattr(got, field)[0])


@pytest.mark.parametrize("solver", ["ls", "lasso"])
def test_batched_solvers_match_float64(solver):
    """A Kernel-SHAP-shaped problem (two rows of weight 1e6, the rest 1)
    against numpy's float64 normal equations, within 1e-6 of scale."""
    x, y, w = _problems(B=4, S=60, D=5, seed=3)
    x = (x > 0).astype(np.float32)
    x[:, 0], x[:, 1] = 0.0, 1.0
    w[:, :2], w[:, 2:] = 1e6, 1.0
    if solver == "ls":
        got = TE.solvers.least_squares_batched(x, y, w, device="cpu")
    else:
        got = TE.solvers.lasso_batched(x, y, 1e-4, w, max_iter=50,
                                       device="cpu")
    for b in range(len(x)):
        xb, yb = x[b].astype(np.float64), y[b].astype(np.float64)
        wb = w[b] / w[b].sum()
        xc, yc = xb - wb @ xb, yb - wb @ yb
        g = (xc * wb[:, None]).T @ xc
        rhs = (xc * wb[:, None]).T @ yc
        if solver == "ls":
            want = np.linalg.solve(g + 1e-6 * np.eye(5), rhs)
        else:
            want, step = np.zeros(5), 1.0 / np.trace(g)
            for _ in range(50):
                z = want - step * (g @ want - rhs)
                want = np.sign(z) * np.maximum(np.abs(z) - step * 1e-4, 0)
        np.testing.assert_allclose(got.coefficients[b].numpy(), want,
                                   rtol=0, atol=1e-6 * _scale(want))


def test_explainer_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    ex = TE.TabularLIME(TM["tab"](), inputCols=list("abc"),
                        backgroundData=TDataset(_tab(8)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.transform(TDataset(_tab(2)))


def test_vector_shap_over_a_gbdt_read_from_the_jax_package():
    """A GBDT the JAX package fits, read by the port from its LightGBM
    text, explained by both packages' VectorSHAP."""
    from synapseml_tpu.models.gbdt import GBDTClassifier as JGBDT
    from synapseml_tpu_torch.models.gbdt.estimators import (
        GBDTClassificationModel)
    rng = np.random.default_rng(11)
    X = rng.normal(size=(256, 4)).astype(np.float32)
    y = ((X[:, 0] - X[:, 2]) > 0).astype(np.float64)
    jm = JGBDT(numIterations=4, numLeaves=4, minDataInLeaf=8).fit(
        JDataset({"features": list(X), "label": y}))
    tm = GBDTClassificationModel.load_native_model_from_string(
        jm.get_model_string(), device="cpu")
    rows, bg = list(X[:3]), list(X[100:132])
    outs = []
    for E, D, m, kw in ((JE, JDataset, jm, {}), (TE, TDataset, tm,
                                                  {"device": "cpu"})):
        ex = E.VectorSHAP(m, inputCol="features", numSamples=64, seed=2,
                          backgroundData=D({"features": bg}), **kw)
        outs.append(ex.transform(D({"features": rows})))
    for w, g in zip(outs[0]["explanation"], outs[1]["explanation"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=SHAP_TOL * _scale(w))
    # the explained outputs themselves agree (the same trees)
    pj = np.stack(jm.transform(JDataset({"features": rows}))["probability"])
    pt = np.stack(tm.transform(TDataset({"features": rows}))["probability"])
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)


def test_pyobject_param_is_one_class():
    """The port's params module defines PyObjectParam once; the
    explainers' model param is that class."""
    import inspect
    import synapseml_tpu_torch.core.params as P
    src = inspect.getsource(P)
    assert src.count("class PyObjectParam(") == 1
    assert isinstance(TE.TabularLIME.model, PyObjectParam)
    assert TE.TabularLIME.model.__class__ is P.PyObjectParam
