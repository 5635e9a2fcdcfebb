"""The port's ``LLMServer`` with its session journal and host KV arena,
held against the JAX package's ``generate`` on the CPU (mirroring
``tests/test_kvtier.py``'s server and failover tests).

``LlamaConfig.tiny(num_layers=2, max_len=96)`` in f32, the JAX init
carried into the port.  A journal holding an interrupted turn resumes
through ``{"session", "resume"}`` with the reference's greedy tokens; a
fully committed turn replies without decoding; a truncated journal is
refused (404, counted).  The SIGKILL failover: a child process that
imports only torch and the port serves a journaled conversation and is
killed at the journal-append site after 3 appends; a fresh server here
replays the journal and its reply equals the reference's uninterrupted
greedy reply.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import urllib.error
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.models import llm as J
from synapseml_tpu_torch.models import llm as P
from synapseml_tpu_torch.models.llm.kvtier import SessionJournal
from synapseml_tpu_torch.serving import LLMServer
from synapseml_tpu_torch.telemetry import get_registry
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    jcfg = J.LlamaConfig.tiny(num_layers=2, max_len=96, dtype=jnp.float32)
    tcfg = P.LlamaConfig.tiny(num_layers=2, max_len=96, dtype=torch.float32)
    jm = J.LlamaModel(jcfg)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))
    tm = P.LlamaModel(tcfg, device="cpu")
    tm.load_state_dict(P.params_from_reference(
        jax.tree.map(np.asarray, nn.meta.unbox(variables)), tcfg, "cpu"))
    return jm, variables, tm


def _prompt(length, seed):
    return np.random.default_rng(seed).integers(1, 512, length).astype(
        np.int32)


def _metric(name, **labels):
    m = get_registry().get(name)
    return 0.0 if m is None else m.value(**labels)


def _post(url, payload, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _ids(row):
    return [int(t) for t in row]


def _server(tm, name, **kw):
    return LLMServer(tm, n_slots=2, max_len=96, device="cpu",
                     api_path=f"/{name}", engine_kwargs={"name": name}, **kw)


def test_resume_continues_interrupted_turn_token_exact(pair, tmp_path):
    jm, variables, tm = pair
    p = _prompt(12, 60)
    ref = J.generate(jm, variables, p[None], max_new_tokens=8)[0]
    jdir = str(tmp_path / "jnl")
    pre = SessionJournal(jdir, name="pt-resume")
    pre.begin("conv", _ids(p), 8)
    pre.append_tokens("conv", _ids(ref[:3]))
    srv = _server(tm, "pt-resume", journal=SessionJournal(jdir,
                                                          name="pt-resume"))
    try:
        ok0 = _metric("kvtier_restores_total", engine="pt-resume",
                      source="journal", outcome="ok")
        status, body = _post(srv.url, {"session": "conv", "resume": True})
        assert status == 200 and json.loads(body)["ids"] == _ids(ref)
        assert _metric("kvtier_restores_total", engine="pt-resume",
                       source="journal", outcome="ok") == ok0 + 1
        # the turn is journaled to its end and compacted at retirement
        st = pre.replay("conv")
        assert st.ids == _ids(p) + _ids(ref)
        with open(pre.path("conv"), "rb") as f:
            assert f.read().count(b"\n") == 1
        m0 = _metric("kvtier_restores_total", engine="pt-resume",
                     source="journal", outcome="miss")
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv.url, {"session": "ghost", "resume": True})
        assert exc.value.code == 404
        assert _metric("kvtier_restores_total", engine="pt-resume",
                       source="journal", outcome="miss") == m0 + 1
    finally:
        srv.close()


def test_fully_committed_turn_replies_without_decoding(pair, tmp_path):
    jm, variables, tm = pair
    p = _prompt(12, 61)
    ref = J.generate(jm, variables, p[None], max_new_tokens=5)[0]
    jdir = str(tmp_path / "jnl")
    pre = SessionJournal(jdir, name="pt-resume-c")
    pre.begin("conv", _ids(p), 5)
    pre.append_tokens("conv", _ids(ref))
    srv = _server(tm, "pt-resume-c", journal_dir=jdir)
    try:
        status, body = _post(srv.url, {"session": "conv", "resume": True})
        assert status == 200 and json.loads(body)["ids"] == _ids(ref)
        assert srv.engine.admissions == 0
    finally:
        srv.close()


def test_truncated_journal_refuses_suffix_replay(pair, tmp_path):
    _, _, tm = pair
    jdir = str(tmp_path / "jnl")
    pre = SessionJournal(jdir, max_bytes_per_session=256, name="pt-res-tr")
    pre.begin("conv", list(range(1, 120)), 8)
    pre.compact("conv")
    assert pre.replay("conv").truncated > 0
    srv = _server(tm, "pt-res-tr", journal_dir=jdir)
    try:
        t0 = _metric("kvtier_restores_total", engine="pt-res-tr",
                     source="journal", outcome="truncated")
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv.url, {"session": "conv", "resume": True})
        assert exc.value.code == 404
        assert _metric("kvtier_restores_total", engine="pt-res-tr",
                       source="journal", outcome="truncated") == t0 + 1
    finally:
        srv.close()


_CRASH_CHILD = textwrap.dedent("""
    import json, os, sys, urllib.request

    import numpy as np
    import torch

    from synapseml_tpu_torch.models.llm import (LlamaConfig, LlamaModel,
                                                params_from_reference)
    from synapseml_tpu_torch.resilience import get_faults
    from synapseml_tpu_torch.serving import LLMServer

    torch.set_num_threads(1)
    cfg = LlamaConfig.tiny(num_layers=2, max_len=96, dtype=torch.float32)
    model = LlamaModel(cfg, device="cpu")
    model.load_state_dict(torch.load(os.environ["SML_TEST_WEIGHTS"]))
    p1 = [int(t) for t in json.loads(os.environ["SML_TEST_P1"])]
    srv = LLMServer(model, n_slots=2, max_len=96, device="cpu",
                    journal_dir=os.environ["SML_TEST_JDIR"],
                    engine_kwargs={"name": "crash-child"})

    def post(payload):
        req = urllib.request.Request(
            srv.url, data=json.dumps(payload).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    out1 = post({"ids": p1, "session": "conv", "max_new_tokens": 5})["ids"]
    print("TURN1", json.dumps(out1), flush=True)
    # turn 2 journals 3 tokens, then the 4th append SIGKILLs the process
    get_faults().configure("kvtier.journal_append=kill:after=3")
    post({"ids": p1 + out1 + [3, 1, 4, 1, 5], "session": "conv",
          "max_new_tokens": 8})
    print("UNREACHABLE", flush=True)
""")


def test_sigkilled_replica_session_resumes_token_exact(pair, tmp_path):
    jm, variables, tm = pair
    jdir = str(tmp_path / "jnl")
    weights = str(tmp_path / "weights.pt")
    torch.save(tm.state_dict(), weights)
    p1 = _prompt(10, 70)
    env = dict(os.environ, SML_TEST_JDIR=jdir, SML_TEST_WEIGHTS=weights,
               SML_TEST_P1=json.dumps(_ids(p1)), PYTHONPATH=_REPO)
    env.pop("SML_FAULTS", None)
    proc = subprocess.run([sys.executable, "-c", _CRASH_CHILD],
                          capture_output=True, text=True, timeout=60,
                          env=env, cwd=str(tmp_path))
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    assert "UNREACHABLE" not in proc.stdout
    turn1 = next(line for line in proc.stdout.splitlines()
                 if line.startswith("TURN1"))
    ref1 = J.generate(jm, variables, p1[None], max_new_tokens=5)[0]
    assert json.loads(turn1.split(None, 1)[1]) == _ids(ref1)
    p2 = np.concatenate([p1, ref1, np.array([3, 1, 4, 1, 5], np.int32)])
    ref2 = J.generate(jm, variables, p2[None], max_new_tokens=8)[0]
    st = SessionJournal(jdir, name="pt-probe").replay("conv")
    assert st.prompt == _ids(p2) and st.committed == _ids(ref2[:3])
    srv = _server(tm, "pt-crash-parent", journal_dir=jdir)
    try:
        status, body = _post(srv.url, {"session": "conv", "resume": True})
        assert status == 200 and json.loads(body)["ids"] == _ids(ref2)
    finally:
        srv.close()


def test_arena_and_journal_knobs_build_and_prefill_pool_raises(pair,
                                                               tmp_path):
    jm, variables, tm = pair
    srv = _server(tm, "pt-knobs", kv_arena_bytes=1 << 22,
                  journal_dir=str(tmp_path / "jnl"))
    try:
        assert isinstance(srv.kv_arena, P.HostKVArena)
        assert srv.engine.kv_arena is srv.kv_arena
        assert srv.kv_arena.max_bytes == 1 << 22
        assert isinstance(srv.journal, SessionJournal)
        # two turns of one session: the second restores from the arena
        p1 = _prompt(12, 80)
        ref1 = J.generate(jm, variables, p1[None], max_new_tokens=6)[0]
        _, body = _post(srv.url, {"ids": _ids(p1), "session": "s",
                                  "max_new_tokens": 6})
        assert json.loads(body)["ids"] == _ids(ref1)
        assert len(srv.kv_arena) == 1
        p2 = np.concatenate([p1, ref1, [9, 8, 7]]).astype(np.int32)
        ref2 = J.generate(jm, variables, p2[None], max_new_tokens=4)[0]
        # a later request retires the first turn's slot to the arena
        # only; the second turn's admit may reuse the device prefix too
        _, body = _post(srv.url, {"ids": _ids(p2), "session": "s",
                                  "max_new_tokens": 4})
        assert json.loads(body)["ids"] == _ids(ref2)
        assert srv.journal.replay("s").ids == _ids(p2) + _ids(ref2)
    finally:
        srv.close()
    # prefill_pool, refused here before the pool was ported, now binds
    # to the server's arena: a fresh turn is handed off, then restored
    from synapseml_tpu_torch.serving import PrefillPool, PrefillWorker
    pool = PrefillPool([PrefillWorker(P.SlotEngine(
        tm, n_slots=2, max_len=128, device="cpu", name="pt-knobs-pf"))],
        name="pt-knobs-pool")
    srv = _server(tm, "pt-knobs-disagg", kv_arena_bytes=1 << 22,
                  prefill_pool=pool)
    try:
        assert srv.prefill_pool is pool and pool.arena is srv.kv_arena
        _, body = _post(srv.url, {"ids": _ids(p1), "max_new_tokens": 6})
        assert json.loads(body)["ids"] == _ids(ref1)
        assert srv.engine.restore_count == 1
    finally:
        srv.close()
