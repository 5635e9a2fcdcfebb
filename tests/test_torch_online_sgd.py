"""The port's online SGD core held against the JAX package's on the CPU:
every loss with AdaGrad on/off, normalization on/off and L1 on/off over
two passes of weighted rows, ``merge_states``, and states carried across
the packages (``state_from_jax`` / ``state_to_numpy``).

Tolerance: every state field within 1e-5 of the field's scale
(``max(1, max |x|)``), and the average loss within 1e-5 relative.  Both
sides compute in f32; XLA's CPU dot and torch's matvec sum the margins in
different orders, and AdaGrad's ``g2 ** power_t`` and the ``/ x_max``
normalization carry that ~1e-7 difference forward (the largest reached
here is ~4e-6, with the poisson loss's ``exp``).
"""

import itertools

import numpy as np
import pytest

import jax.numpy as jnp
from synapseml_tpu.models.online import sgd as J
from synapseml_tpu_torch.models.online import sgd as T
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

LOSSES = ("squared", "logistic", "hinge", "quantile", "poisson")
TOL = 1e-5


def _data(loss, n=600, d=12, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d))
         * rng.uniform(0.1, 3.0, size=d)).astype(np.float32)
    m = x @ rng.normal(size=d)
    if loss in ("logistic", "hinge"):
        y = np.where(m > 0, 1.0, -1.0)
    elif loss == "poisson":
        y = rng.poisson(np.exp(0.2 * m / np.abs(m).max()))
    else:
        y = m + 0.1 * rng.normal(size=n)
    sw = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return x, y.astype(np.float32), sw


def _assert_states(tstate, jstate, tol=TOL):
    got = T.state_to_numpy(tstate)
    for f in J.SGDState._fields:
        want = np.asarray(getattr(jstate, f))
        scale = max(1.0, float(np.max(np.abs(want))))
        np.testing.assert_allclose(got[f], want, rtol=0, atol=tol * scale,
                                   err_msg=f)


@pytest.mark.parametrize("loss,adaptive,normalized,l1", [
    (loss, a, nm, l1) for loss, a, nm, l1 in itertools.product(
        LOSSES, (True, False), (True, False), (0.0, 1e-3))])
def test_two_passes_equal_jax(loss, adaptive, normalized, l1):
    x, y, sw = _data(loss)
    cfg = dict(loss=loss, adaptive=adaptive, normalized=normalized, l1=l1,
               l2=1e-4, num_passes=2, batch_size=32, quantile_tau=0.3)
    js, jst = J.train_sgd(x, y, J.SGDConfig(**cfg), sample_weight=sw)
    ts, tst = T.train_sgd(x, y, T.SGDConfig(**cfg), sample_weight=sw,
                          device="cpu")
    _assert_states(ts, js)
    assert tst["average_loss"] == pytest.approx(jst["average_loss"],
                                                rel=TOL)
    assert tst["examples"] == pytest.approx(jst["examples"], rel=1e-6)
    np.testing.assert_allclose(T.predict_margin(ts, x),
                               J.predict_margin(js, x), rtol=0,
                               atol=TOL * max(1.0, np.abs(
                                   J.predict_margin(js, x)).max()))


def test_padded_last_block_and_warm_start():
    """A row count off the batch size pads the last block with masked
    rows; a warm start from the JAX package's state continues as the JAX
    package does."""
    x, y, sw = _data("squared", n=333)
    cfg = dict(loss="squared", num_passes=1, batch_size=32)
    js0, _ = J.train_sgd(x[:200], y[:200], J.SGDConfig(**cfg))
    js, jst = J.train_sgd(x[200:], y[200:], J.SGDConfig(**cfg), init=js0)
    ts, tst = T.train_sgd(x[200:], y[200:], T.SGDConfig(**cfg),
                          init=T.state_from_jax(js0, "cpu"), device="cpu")
    _assert_states(ts, js)
    assert tst["examples"] == jst["examples"] == 333.0


def test_merge_states_equals_jax():
    x, y, _ = _data("squared")
    cfg = dict(loss="squared", batch_size=16)
    jparts = [J.train_sgd(x[i::3], y[i::3], J.SGDConfig(**cfg))[0]
              for i in range(3)]
    tparts = [T.state_from_jax(s, "cpu") for s in jparts]
    for weights in (None, [1.0, 2.0, 0.5]):
        _assert_states(T.merge_states(tparts, weights),
                       J.merge_states(jparts, weights), tol=1e-7)


def test_state_round_trip_is_exact():
    x, y, _ = _data("logistic")
    js, _ = J.train_sgd(x, y, J.SGDConfig(loss="logistic"))
    ts = T.state_from_jax(js, "cpu")
    back = J.SGDState(**{k: jnp.asarray(v)
                         for k, v in T.state_to_numpy(ts).items()})
    for f in J.SGDState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(js, f)))
        assert getattr(ts, f).dtype == T.torch.float32


def test_step_is_functional_and_pass_reads_no_host_value(monkeypatch):
    """``make_scan_step`` leaves its inputs alone, and a pass never reads
    a device value on the host (the sums are read once, after it)."""
    x, y, sw = _data("logistic", n=96)
    step = T.make_scan_step(T.SGDConfig(loss="logistic"))
    st = T.init_state(x.shape[1], "cpu")
    before = T.state_to_numpy(st)
    blk = tuple(T.torch.from_numpy(a) for a in
                (x[:32], y[:32], sw[:32], np.ones(32, np.float32)))
    new, loss, w_sum = step(st, blk)
    for f, v in T.state_to_numpy(st).items():
        np.testing.assert_array_equal(v, before[f])
    assert float(w_sum) == pytest.approx(float(sw[:32].sum()))
    reads = []
    run = T.BlockPass(T.SGDConfig(loss="logistic"), st,
                      T._pad_blocks(x, y, sw, 32), T.torch.device("cpu"))
    monkeypatch.setattr(T.torch.Tensor, "item",
                        lambda self: reads.append(1) or 0.0)
    monkeypatch.setattr(T.torch.Tensor, "tolist",
                        lambda self: reads.append(1) or [])
    monkeypatch.setattr(T.torch.Tensor, "__float__",
                        lambda self: reads.append(1) or 0.0)
    run.run_pass(graph=True)
    assert reads == [] and run.steps == 3


def test_mesh_is_refused_before_any_work():
    """A mesh trains (tests/test_torch_online_mesh.py); anything but a
    ProcessMesh is refused before any work."""
    x, y, _ = _data("squared", n=64)
    with pytest.raises(TypeError, match="ProcessMesh"):
        T.train_sgd(x, y, T.SGDConfig(), mesh=object(), device="cpu")


def test_cuda_default_raises_without_a_card():
    if T.torch.cuda.is_available():
        pytest.skip("a card is present")
    x, y, _ = _data("squared", n=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.train_sgd(x, y, T.SGDConfig())
