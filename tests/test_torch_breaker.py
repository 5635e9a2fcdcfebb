"""The port's circuit breaker (``synapseml_tpu_torch.resilience.breaker``)
held against the JAX package's on the CPU.

Seeded sequences of ``allow`` / ``record_success`` / ``record_failure`` /
``reset`` calls and clock steps drive both packages' ``CircuitBreaker``
on one injected clock; the state, ``retry_after_s``, each call's answer
and the three metrics (state gauge, transitions, rejections, each read
from its own package's registry) must be equal after every step.  Also:
``breaker_for`` shares one breaker per endpoint, ``drop_breaker`` removes
the gauge row and a dropped breaker's late transition writes nothing.
"""

import itertools
import threading

import numpy as np
import pytest

from synapseml_tpu.resilience import breaker as JB
from synapseml_tpu.telemetry import get_registry as j_registry
from synapseml_tpu_torch.resilience import breaker as PB
from synapseml_tpu_torch.telemetry import get_registry as p_registry

_names = itertools.count()


def _name(tag):
    return f"pt-brk-{tag}-{next(_names)}"


def _metrics(registry, name):
    reg = registry()
    state = reg.get("resilience_breaker_state")
    trans = reg.get("resilience_breaker_transitions_total")
    rej = reg.get("resilience_breaker_rejected_total")
    return (state.series().get((name,)),
            {to: trans.value(breaker=name, to=to)
             for to in ("closed", "open", "half_open")},
            rej.value(breaker=name))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("threshold,cooldown,probes",
                         [(1, 1.0, 1), (3, 2.5, 1), (2, 0.5, 3)])
def test_seeded_sequence_equal_to_reference(seed, threshold, cooldown,
                                            probes):
    """300 seeded operations: every answer, state, retry-after and metric
    equal to the JAX breaker's at every step (exact: the two share the
    clock and the arithmetic)."""
    rng = np.random.default_rng(seed)
    now = [0.0]
    name = _name(f"seq{seed}")
    j = JB.CircuitBreaker(name, threshold, cooldown, probes,
                          clock=lambda: now[0])
    p = PB.CircuitBreaker(name, threshold, cooldown, probes,
                          clock=lambda: now[0])
    ops = ("allow", "success", "failure", "failure", "tick", "reset")
    for step in range(300):
        op = ops[int(rng.choice(len(ops), p=[.3, .15, .3, .1, .14, .01]))]
        if op == "allow":
            assert j.allow() == p.allow(), step
        elif op == "success":
            j.record_success(), p.record_success()
        elif op == "failure":
            j.record_failure(), p.record_failure()
        elif op == "reset":
            j.reset(), p.reset()
        else:
            now[0] += float(rng.uniform(0.0, 1.5 * cooldown))
        assert j.retry_after_s() == p.retry_after_s(), step
        assert j.state == p.state, step
        assert _metrics(j_registry, name) == _metrics(p_registry, name), step


def test_open_error_and_validation_equal():
    for mod in (JB, PB):
        with pytest.raises(ValueError, match="failure_threshold"):
            mod.CircuitBreaker(_name("bad"), failure_threshold=0)
    je, pe = JB.CircuitOpenError("x", 2.25), PB.CircuitOpenError("x", 2.25)
    assert str(je) == str(pe) and je.retry_after_s == pe.retry_after_s
    assert isinstance(pe, RuntimeError)


def test_breaker_for_shares_and_drop_removes_gauge_row():
    name = _name("shared")
    a = PB.breaker_for(name, failure_threshold=2, cooldown_s=60.0)
    assert PB.breaker_for(name) is a              # one per endpoint
    a.record_failure(), a.record_failure()
    assert PB.breaker_for(name).state == "open"
    gauge = p_registry().get("resilience_breaker_state")
    assert gauge.series()[(name,)] == 1
    PB.drop_breaker(name)
    assert name not in PB._breakers
    assert (name,) not in gauge.series()          # the live row is gone
    trans = p_registry().get("resilience_breaker_transitions_total")
    assert trans.value(breaker=name, to="open") == 1   # history stays
    # a caller still holding the dropped object keeps a working machine
    # but never resurrects the row
    a.reset()
    assert a.state == "closed" and (name,) not in gauge.series()
    # a new breaker under the same name starts fresh
    b = PB.breaker_for(name)
    assert b is not a and b.state == "closed"
    assert gauge.series()[(name,)] == 0
    PB.drop_breaker(name)
    PB.drop_breaker(name)                         # no-op when absent


def test_drop_wins_race_against_inflight_transitions():
    """Transitions racing ``drop_breaker`` on other threads: once the drop
    returned, no row for the name is ever written again."""
    import sys
    name = _name("race")
    b = PB.breaker_for(name, failure_threshold=1, cooldown_s=0.0)
    gauge = p_registry().get("resilience_breaker_state")
    stop = threading.Event()

    def churn():
        while not stop.is_set():
            b.record_failure()
            b.allow()
            b.record_success()

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=churn) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        PB.drop_breaker(name)
        for _ in range(2000):
            assert (name,) not in gauge.series()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert (name,) not in gauge.series()
