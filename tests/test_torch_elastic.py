"""Elastic resume and resize of the port's gang supervisor on the CPU.

- The resize policy with no processes (the JAX package's
  ``TestResizePolicyUnit``, tests/test_gang.py): min_ranks bounds, a
  persistent same-rank blame shrinks, stragglers are never blamed, the
  floor, the budget and the cooldown, requested and capacity-driven
  resizes at a launch boundary, the metric, history and note of a
  resize, monitors at the live size, and a gang that fails every
  attempt shrinking to its floor with post-mortems that carry the
  resizes.
- Subprocess gangs of gloo ranks (the JAX package's tests/test_gang.py
  ``TestGangSubprocess``), on ``tests/torch_gang_tasks.py``'s port
  copies of ``elastic_counter`` and ``gbdt_elastic_digest``: a SIGKILLed
  rank resumed at the same size, bit-exact, with the recovery clocked; a
  persistent rank loss shrinking 2 → 1 and resuming; a requested grow
  between checkpoints; a GBDT gang killed at its second checkpoint
  whose model string and margins equal the fault-free gang's bit for bit
  (at 400 x 8 rows); and a 2-rank int8 GBDT checkpoint resumed by a
  1-rank gang (the resize noted, never refused; a codec toggle still
  refused), whose worker sees the kernel build cache's directory.

The fault-free ``elastic_counter`` state is the recurrence itself
(``counter_state``), computed here without a gang.  Last, the kernel
build cache's attribution: a build counted once a process under the
thread's compile label.
"""

import json
import threading
import time

import pytest

from synapseml_tpu_torch.parallel import (GangSupervisor, HeartbeatMonitor,
                                          WorkerFailure,
                                          run_on_local_cluster)
from synapseml_tpu_torch.resilience import RetryPolicy, get_faults
from synapseml_tpu_torch.telemetry import get_registry
from torch_gang_tasks import counter_state
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

#: every gang's own limit, far below pytest's faulthandler_timeout
GANG_TIMEOUT_S = 120.0


@pytest.fixture
def faults():
    """The port's process-wide fault registry, cleared around each test,
    its backoffs recorded and not slept."""
    reg = get_faults()
    reg.clear()
    reg.seed(20260803)
    reg.no_sleep = True
    yield reg
    reg.clear()
    reg.no_sleep = False
    reg.record_calls = False


# -- the resize policy, no processes ------------------------------------------------

def _sup(**kw):
    kw.setdefault("n_processes", 4)
    kw.setdefault("min_ranks", 1)
    kw.setdefault("shrink_after", 2)
    return GangSupervisor("torch_gang_tasks:never_runs", device="cpu", **kw)


@pytest.mark.parametrize("min_ranks", [0, 5])
def test_min_ranks_outside_range_raises(min_ranks):
    with pytest.raises(ValueError, match="min_ranks"):
        _sup(min_ranks=min_ranks)


def test_persistent_same_rank_failure_shrinks():
    sup = _sup()
    assert sup._plan_after_failure({3: "exit -9"}) is None
    assert sup._plan_after_failure({3: "exit -9 (last step 5)"}) == 3


def test_transient_alternating_failures_never_shrink():
    sup = _sup()
    for r in (0, 1, 2, 3, 0, 1):      # never the same rank twice running
        assert sup._plan_after_failure({r: "hang at step 2"}) is None


def test_straggler_advisory_is_not_blamed():
    sup = _sup()
    sup._plan_after_failure({1: "straggler at step 2 (leader at 9)",
                             2: "hang at step 4"})
    target = sup._plan_after_failure({1: "straggler at step 3 (leader at "
                                      "11)", 2: "hang at step 4"})
    assert target == 3
    assert 1 not in sup._fail_streak


@pytest.mark.parametrize("case", ["floor", "no_min_ranks", "budget",
                                  "cooldown"])
def test_automatic_shrink_is_held_back(case):
    """The same persistent blame shrinks nothing when the floor is the
    gang's size, without min_ranks, with the budget spent, or inside the
    shrink cooldown."""
    if case == "floor":
        sup, rank = _sup(min_ranks=4), 0
    elif case == "no_min_ranks":
        sup, rank = GangSupervisor("torch_gang_tasks:never_runs", 2,
                                   device="cpu"), 1
    else:
        sup = _sup(**({"max_resizes": 1} if case == "budget"
                      else {"resize_cooldown_s": 3600.0}))
        sup._apply_resize(0, 3, cause="exit", automatic=True)
        rank = 2
    sup._plan_after_failure({rank: "exit -9"})
    assert sup._plan_after_failure({rank: "exit -9"}) is None


def test_requested_resize_applies_at_launch_boundary():
    sup = _sup()
    sup.resize(2)
    assert sup._interrupt.is_set()
    sup._plan_before_launch(0)
    assert sup.world_size == 2
    assert not sup._interrupt.is_set()      # the request took its wakeup
    assert sup.resize_history[-1]["direction"] == "shrink"
    assert sup.resize_history[-1]["cause"] == "requested"
    with pytest.raises(ValueError):
        sup.resize(0)
    with pytest.raises(ValueError, match="min_ranks"):
        _sup(min_ranks=2).resize(1)


def test_resize_to_current_size_is_a_noop():
    sup = _sup()
    sup.resize(2)                       # a pending shrink request
    sup.resize(4)                       # the current size: cancels it
    assert sup._requested_size is None
    sup._plan_before_launch(0)
    assert sup.world_size == 4 and sup.resize_history == []


def test_capacity_shrink_honors_cooldown():
    sup = _sup(resize_cooldown_s=3600.0, capacity_fn=lambda: 1)
    sup._apply_resize(0, 3, cause="exit", automatic=True)
    sup._plan_before_launch(1)          # capacity 1 < world 3 ...
    assert sup.world_size == 3          # ... but the brake holds


def test_capacity_fn_grows_degraded_gang_back():
    cap = [1]
    sup = _sup(capacity_fn=lambda: cap[0])
    seen = []
    sup.add_resize_listener(seen.append)
    sup._apply_resize(0, 2, cause="exit", automatic=True)    # degraded
    sup._plan_before_launch(1)
    assert sup.world_size == 1          # capacity fell below the gang
    cap[0] = 8
    sup._plan_before_launch(2)
    assert sup.world_size == 4          # back, clamped to n_processes
    assert [e["direction"] for e in sup.resize_history] == [
        "shrink", "shrink", "grow"]
    assert seen == sup.resize_history


def test_apply_resize_records_metric_history_and_note(faults):
    faults.record_calls = True
    c = get_registry().counter("gang_resizes_total", "",
                               ("task", "direction"))
    before = c.value(task="torch_gang_tasks:never_runs", direction="shrink")
    sup = _sup()
    sup._apply_resize(2, 3, cause="hang", automatic=True)
    assert c.value(task="torch_gang_tasks:never_runs",
                   direction="shrink") == before + 1
    ev = sup.resize_history[-1]
    assert (ev["from"], ev["to"], ev["attempt"]) == (4, 3, 2)
    notes = faults.calls_for("gang.resize")
    assert notes and notes[-1]["to"] == 3
    assert sup._fail_streak == {}       # relaunched ranks renumber


def test_monitor_built_at_live_size():
    sup = _sup(heartbeat_interval_s=0.5)
    sup._apply_resize(0, 2, cause="exit", automatic=True)
    assert sorted(sup._new_monitor(None, None).ranks) == [0, 1]
    m = HeartbeatMonitor(0, 0.5, ranks=(0, 2))
    assert sorted(m.ranks) == [0, 2]
    m.observe(2, step=4)
    assert m.last_steps() == {0: None, 2: 4}


def test_all_ranks_failing_shrinks_to_floor(faults, tmp_path):
    """Every attempt fails whole-gang (injected), so after shrink_after
    attempts the gang shrinks to min_ranks and keeps retrying there; the
    post-mortems carry each attempt's world size and the resizes."""
    faults.inject("launcher.attempt", "error")
    obs = tmp_path / "obs"
    sup = GangSupervisor(
        "torch_gang_tasks:never_runs", n_processes=2, min_ranks=1,
        shrink_after=2, observability_dir=str(obs), device="cpu",
        retry_policy=RetryPolicy(max_retries=3, base_s=0.0, seed=7))
    with pytest.raises(WorkerFailure):
        sup.run()
    assert sup.world_size == 1
    assert [(e["from"], e["to"]) for e in sup.resize_history] == [(2, 1)]
    with open(obs / "postmortem.json") as f:
        bundle = json.load(f)
    assert bundle["world_size"] == 1
    assert bundle["resize_history"][0]["direction"] == "shrink"
    with open(obs / "postmortem-attempt0.json") as f:
        assert json.load(f)["world_size"] == 2


# -- real gangs of gloo ranks ------------------------------------------------------

def _supervisor(task, n, tmp_path, name, **kw):
    # a hang is 3 s of silence: under a loaded test machine a rank's
    # emitter can miss a few 0.5 s beats without being hung
    kw.setdefault("heartbeat_interval_s", 0.5)
    kw.setdefault("hang_intervals", 6.0)
    return GangSupervisor(f"torch_gang_tasks:{task}", n, device="cpu",
                          timeout_s=GANG_TIMEOUT_S,
                          checkpoint_dir=str(tmp_path / name), **kw)


def test_sigkill_one_rank_resume_bit_exact(faults, tmp_path):
    """A rank killed mid-run; the relaunch resumes from the last
    complete checkpoint, its state equal to the fault-free one, and the
    recovery is clocked."""
    args = {"steps": 8, "step_sleep_s": 0.25}
    sup = _supervisor(
        "elastic_counter", 1, tmp_path, "elastic", task_args=args,
        retry_policy=RetryPolicy(max_retries=3, base_s=0.01, seed=1),
        env_extra={"SML_FAULTS": "mp.step=kill_rank:rank=0:after=3"})
    out = sup.run()
    assert sup.restarts >= 1
    assert out[0]["state"] == counter_state(1, 8)
    assert out[0]["resumed_from"] > 0
    assert sup.last_recovery_s is not None and sup.last_recovery_s > 0


def test_shrink_to_survive_persistent_rank_loss(faults, tmp_path):
    """Rank 1 dies at the same step of every attempt: after two blames
    the gang shrinks to one rank, resumes, and ends with the fault-free
    state; the departed ranks leave no heartbeat-age series."""
    args = {"steps": 8, "step_sleep_s": 0.2}
    sup = _supervisor(
        "elastic_counter", 2, tmp_path, "shrink", task_args=args,
        min_ranks=1, shrink_after=2,
        retry_policy=RetryPolicy(max_retries=4, base_s=0.01, seed=3),
        env_extra={"SML_FAULTS": "mp.step=kill_rank:rank=1:after=2"})
    out = sup.run()
    assert len(out) == 1 and sup.world_size == 1
    assert out[0]["world_size"] == 1
    assert out[0]["state"] == counter_state(1, 8)
    assert out[0]["resumed_from"] > 0
    assert [(e["from"], e["to"], e["direction"])
            for e in sup.resize_history] == [(2, 1, "shrink")]
    assert sup.last_recovery_s is not None and sup.last_recovery_s > 0
    g = get_registry().gauge("rank_heartbeat_age_seconds", "", ("rank",))
    assert g.series() == {}


def test_grow_on_request_between_checkpoints(faults, tmp_path):
    """A gang started at one rank gets ``resize(2)`` mid-run: the healthy
    attempt is torn down (not a failure), relaunches at two ranks and
    resumes; both ranks end with the fault-free state."""
    args = {"steps": 14, "step_sleep_s": 0.3}
    sup = _supervisor(
        "elastic_counter", 2, tmp_path, "grow", task_args=args,
        min_ranks=1,
        retry_policy=RetryPolicy(max_retries=2, base_s=0.01, seed=4))
    sup.resize(1)                    # start degraded
    grown = threading.Event()

    def grower():
        deadline = time.monotonic() + 100.0
        while time.monotonic() < deadline:
            m = sup.monitor
            if (m is not None and sup.world_size == 1
                    and (m.max_step() or -1) >= 2):
                sup.resize(2)
                grown.set()
                return
            time.sleep(0.05)

    t = threading.Thread(target=grower, daemon=True)
    t.start()
    out = sup.run()
    t.join(timeout=5.0)
    assert grown.is_set()
    assert len(out) == 2 and sup.world_size == 2
    assert [r["state"] for r in out] == [counter_state(1, 14)] * 2
    assert out[0]["resumed_from"] > 0
    assert [e["direction"] for e in sup.resize_history] == ["shrink", "grow"]
    assert sup.resize_history[-1]["cause"] == "requested"
    assert sup.last_failure is None      # a resize teardown is no failure
    assert sup.last_recovery_s is not None


def test_gbdt_gang_killed_at_checkpoint_resumes_bit_exact(faults, tmp_path):
    """Rank 1 of a 2-rank GBDT gang is SIGKILLed after its second
    published checkpoint; the relaunched gang resumes from it, and the
    model string and margins equal the fault-free gang's bit for bit."""
    args = {"device": "cpu", "n": 400, "f": 8}
    clean = run_on_local_cluster(
        "torch_gang_tasks:gbdt_elastic_digest", 2, task_args=args,
        device="cpu", timeout_s=GANG_TIMEOUT_S, heartbeat_interval_s=0.5,
        checkpoint_dir=str(tmp_path / "clean"))
    sup = _supervisor(
        "gbdt_elastic_digest", 2, tmp_path, "elastic", task_args=args,
        retry_policy=RetryPolicy(max_retries=2, base_s=0.01, seed=5),
        env_extra={"SML_FAULTS":
                   "gbdt.checkpoint=kill_rank:rank=1:after=1:times=1"})
    out = sup.run()
    assert sup.restarts >= 1
    assert out[0]["model_md5"] == clean[0]["model_md5"] \
        == out[1]["model_md5"]
    assert out[0]["margins"] == clean[0]["margins"]
    assert sup.last_recovery_s is not None and sup.last_recovery_s > 0


def test_gbdt_resize_resume_not_refused(tmp_path):
    """A 2-rank int8 gang writes 3 iterations; a 1-rank int8 gang resumes
    them to 6: the resize is noted (2 → 1), not refused, while a codec
    toggle against the same checkpoint still raises.  The 1-rank gang's
    supervisor also carries a kernel build cache and a tuning-table
    directory: its worker sees both variables, builds into the cache,
    and its tuning plane reads the table directory."""
    ck, cache = str(tmp_path / "gbdt"), str(tmp_path / "kernels")
    tunes = str(tmp_path / "tunes")
    base = {"device": "cpu", "n": 300, "f": 6, "compression": "int8"}
    run_on_local_cluster("torch_gang_tasks:gbdt_elastic_digest", 2,
                         task_args={**base, "iters": 3}, device="cpu",
                         timeout_s=GANG_TIMEOUT_S, checkpoint_dir=ck)
    (one,) = GangSupervisor(
        "torch_gang_tasks:gbdt_elastic_digest", 1,
        task_args={**base, "iters": 6, "toggle_codec": "none"},
        device="cpu", timeout_s=GANG_TIMEOUT_S, checkpoint_dir=ck,
        compile_cache_dir=cache, tune_table_dir=tunes).run()
    assert one["num_trees"] == 6
    assert one["resize_notes"] == [{"saved": 2, "current": 1}]
    assert "collective_compression" in one["toggle_error"]
    assert one["compile_cache_env"] == cache
    assert one["compile_cache_dir"] == cache == one["build_dir"]
    assert one["tune_table_env"] == tunes == one["tune_plane_dir"]


def test_kernel_builds_are_attributed_to_the_compile_label():
    """Each library is reported once a process: a build (miss) lands in
    ``llm_compile_seconds{program}`` under the thread's compile label and
    in the miss counter, a library found built in the hit counter."""
    from synapseml_tpu_torch.kernels import _build
    from synapseml_tpu_torch.parallel import compilecache as CC
    CC.install_compile_listeners()
    before = CC.cache_stats()
    with CC.compile_label("probe_program"):
        _build._report("miss", "probe", "/nonexistent/libprobe_a.so", 2.5)
    for _ in range(2):
        _build._report("hit", "probe", "/nonexistent/libprobe_b.so", 0.0)
    after = CC.cache_stats()
    assert {k: after[k] - before[k] for k in after} == {
        "compiles": 1, "cache_misses": 1, "cache_hits": 1}
    h = get_registry().get("llm_compile_seconds").series()
    assert h[("probe_program",)]["sum"] == 2.5
    assert CC.current_label() == "unattributed"
