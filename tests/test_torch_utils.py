"""The port's runtime utilities (``core/utils.py``) under the contracts
``tests/test_core.py`` holds the JAX package's to, and the compensated
sum equal to the JAX package's bit for bit."""

import threading

import numpy as np
import pytest

from synapseml_tpu.core.utils import KahanSum as JKahanSum
from synapseml_tpu_torch.core import (KahanSum, SharedVariable, StopWatch,
                                      assert_models_equal, retry,
                                      retry_with_timeout, using)
from synapseml_tpu_torch.core.utils import interpolate_template
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def test_retry_with_timeout():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("boom")
        return 42

    assert retry_with_timeout(flaky, timeout_s=5) == 42
    assert len(calls) == 3

    with pytest.raises(RuntimeError):
        retry_with_timeout(lambda: 1 / 0, timeout_s=1)


def test_retry_with_timeout_times_out_a_hung_attempt():
    import time
    started = []

    def slow():
        started.append(1)
        time.sleep(0.5)
        return 1

    with pytest.raises(RuntimeError, match="exhausted 2 attempts"):
        retry_with_timeout(slow, timeout_s=0.05, backoffs_ms=(0, 1))
    assert len(started) == 2


def test_retry_attempts_and_last_error():
    calls = []

    def always():
        calls.append(1)
        raise ValueError(f"try {len(calls)}")

    with pytest.raises(ValueError, match="try 3"):
        retry(always, [1, 1])
    assert len(calls) == 3
    n = []
    assert retry(lambda: n.append(1) or len(n), [1, 1]) == 1


def test_using_closes_on_error():
    class Res:
        closed = False

        def close(self):
            self.closed = True

    r = Res()
    with pytest.raises(KeyError):
        with using(r):
            raise KeyError("x")
    assert r.closed
    with using(object()) as o:          # no close(): nothing to call
        assert o is not None


def test_stopwatch_and_kahan():
    sw = StopWatch()
    with sw.measure():
        sum(range(1000))
    assert sw.elapsed_ns > 0
    k = KahanSum()
    for _ in range(10):
        k += 0.1
    assert abs(k.value - 1.0) < 1e-15


def test_stopwatch_accumulates_and_restarts():
    sw = StopWatch()
    sw.start()
    sw.stop()
    first = sw.elapsed_ns
    with sw.measure():
        sum(range(1000))
    assert sw.elapsed_ns >= first
    assert sw.elapsed_ms == sw.elapsed_ns / 1e6
    sw.restart()
    sw.stop()
    assert sw.elapsed_s < 1.0


def test_shared_variable_builds_once_across_threads():
    built = []
    barrier = threading.Barrier(8)

    def ctor():
        built.append(1)
        return object()

    sv = SharedVariable(ctor)
    got = []

    def worker():
        barrier.wait()
        got.append(sv.get())

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(built) == 1 and all(g is got[0] for g in got)
    sv.reset()
    assert sv.get() is not got[0] and len(built) == 2


@pytest.mark.parametrize("seed", [0, 1])
def test_kahan_sum_equals_jax(seed):
    xs = np.random.default_rng(seed).normal(scale=1e8, size=5000)
    t, j = KahanSum(), JKahanSum()
    for x in xs:
        t += float(x)
        j += float(x)
    assert t.value == j.value


def test_assert_models_equal():
    from synapseml_tpu_torch.ops.stages import DropColumns
    a = DropColumns(cols=["x"])
    assert_models_equal(a, DropColumns(cols=["x"]))
    with pytest.raises(AssertionError):
        assert_models_equal(a, DropColumns(cols=["z"]))


def test_assert_models_equal_arrays_nan_and_loose():
    from synapseml_tpu_torch.ops.featurize import CleanMissingDataModel
    a = CleanMissingDataModel(inputCols=["b"], outputCols=["b"],
                              fillValues=[float("nan")])
    b = CleanMissingDataModel(inputCols=["b"], outputCols=["b"],
                              fillValues=[float("nan")])
    with pytest.raises(AssertionError):      # [nan] != [nan] as lists
        assert_models_equal(a, b)
    assert_models_equal(a, b, loose_params=["fillValues"])
    with pytest.raises(AssertionError):
        assert_models_equal(a, DropColumnsLike())


class DropColumnsLike:
    params = ()


def test_interpolate_template_kept():
    assert interpolate_template("hi {a} {b}", {"a": 1}.get) == "hi 1 {b}"
