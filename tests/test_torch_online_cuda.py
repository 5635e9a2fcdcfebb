"""The online learners on the card against the same code on the CPU, and
the CUDA-graph pass against the eager pass.  Marked ``gpu``: every test
skips where no card is present (the check runs inside the fixture, so
every worker collects the same tests).  Run on a machine with a card:

    python -m pytest -m gpu tests/test_torch_online_cuda.py

Tolerances: states and outputs within 1e-4 of their scale (max(1,
max |x|)); the card's reductions (the matvec, the column sums and
maxima) sum in other orders than the CPU's, ~1e-6, and AdaGrad carries
that forward.  The graph pass and the eager pass run the same kernels on
the same buffers: their states are equal bit for bit.
"""

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.core import Dataset
from synapseml_tpu_torch.models import online as O
from synapseml_tpu_torch.models.online import sgd as SGD
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

pytestmark = pytest.mark.gpu

TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _data(loss, n=4096, d=64, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d))
         * rng.uniform(0.1, 3.0, size=d)).astype(np.float32)
    m = x @ rng.normal(size=d) / np.sqrt(d) * 2
    if loss in ("logistic", "hinge"):
        y = np.where(m > 0, 1.0, -1.0)
    elif loss == "poisson":
        y = rng.poisson(np.exp(0.3 * m / m.std()))
    else:
        y = m + 0.1 * rng.normal(size=n)
    return x, y.astype(np.float32), rng.uniform(0.5, 2, n).astype(np.float32)


def _assert_states(a, b, tol=TOL):
    na, nb = O.state_to_numpy(a), O.state_to_numpy(b)
    for f in na:
        np.testing.assert_allclose(
            na[f], nb[f], rtol=0,
            atol=tol * max(1.0, float(np.abs(nb[f]).max())), err_msg=f)


@pytest.mark.parametrize("loss", ["squared", "logistic", "hinge",
                                  "quantile", "poisson"])
@pytest.mark.parametrize("adaptive", [True, False])
def test_train_sgd_on_card_equals_cpu(dev, loss, adaptive):
    x, y, sw = _data(loss)
    lr = 0.05 if loss == "poisson" else 0.5
    cfg = SGD.SGDConfig(loss=loss, adaptive=adaptive, num_passes=2,
                        learning_rate=lr, l1=1e-4)
    card, sc = SGD.train_sgd(x, y, cfg, sample_weight=sw, device=dev)
    cpu, sh = SGD.train_sgd(x, y, cfg, sample_weight=sw, device="cpu")
    assert card.w.device.type == "cuda"
    _assert_states(card, cpu)
    assert sc["average_loss"] == pytest.approx(sh["average_loss"], rel=TOL)


@pytest.mark.parametrize("n", [64 * 32, 64 * 32 * 3 + 32 * 5 + 7])
def test_graph_pass_equals_eager_bitwise(dev, n):
    """Whole graph chunks plus an eager remainder (and a padded last
    block) against every step eager: equal bit for bit, sums included."""
    x, y, sw = _data("logistic", n=n)
    cfg = SGD.SGDConfig(loss="logistic", num_passes=2)
    g, gs = SGD.train_sgd(x, y, cfg, sample_weight=sw, device=dev,
                          graph=True)
    e, es = SGD.train_sgd(x, y, cfg, sample_weight=sw, device=dev,
                          graph=False)
    for a, b in zip(g, e):
        assert torch.equal(a, b)
    assert gs == es


def test_graph_replays_after_reset(dev):
    x, y, sw = _data("squared", n=64 * 32 * 2)
    cfg = SGD.SGDConfig(loss="squared")
    init = SGD.init_state(x.shape[1], dev)
    run = SGD.BlockPass(cfg, init, SGD._pad_blocks(x, y, sw, 32), dev)
    run.run_pass(graph=True)
    first = [t.clone() for t in run.state]
    graph = run.graph
    run.reset(init)
    run.run_pass(graph=True)
    assert run.graph is graph
    for a, b in zip(run.state, first):
        assert torch.equal(a, b)


def test_estimators_on_card_equal_cpu(dev):
    x, y, sw = _data("logistic", n=2048)
    ds = Dataset({"features": list(x), "label": (y > 0).astype(float),
                  "w": sw})
    outs = {}
    for d in (str(dev), "cpu"):
        m = O.OnlineSGDClassifier(numPasses=2, weightCol="w",
                                  device=d).fit(ds)
        outs[d] = np.asarray(m.transform(ds)["rawPrediction"])
    np.testing.assert_allclose(outs[str(dev)], outs["cpu"], rtol=0,
                               atol=TOL * np.abs(outs["cpu"]).max())
    lines = np.asarray([f"{1 if i % 2 else -1} |w t{i % 7} {'p' if i % 2 else 'n'}"
                        for i in range(512)], object)
    prog = {d: O.OnlineGenericProgressive(lossFunction="logistic",
                                          numBits=8, device=d).transform(
        Dataset({"value": lines}))["prediction"] for d in (str(dev), "cpu")}
    np.testing.assert_allclose(prog[str(dev)], prog["cpu"], rtol=0,
                               atol=TOL)
