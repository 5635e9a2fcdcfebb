"""The port's host KV arena, transfer codec, session journal and the slot
engine's arena path, held against the JAX package's ``kvtier`` on the CPU
(mirroring ``tests/test_kvtier.py``).

The arena round-trips bit-exactly at f32 and bf16, drops its LRU tail
under pressure, refuses an entry over budget whole, lets a longer spill
supersede its prefix and drops a corrupted entry at fetch.  The codec's
bytes equal the reference's on the same rows, and each package unpacks
the other's frame.  A journal written by either package replays in the
other.  The engine (``LlamaConfig.tiny(num_layers=2, max_len=96)`` in f32,
the JAX init carried into the port): a restore from the arena, a corrupt
spill, a miss between probe and fetch, preempt/resume with the arena and
a resume on a fresh engine all give the JAX ``generate``'s greedy tokens
exactly; the compile plane's lattice has the reference's restore rows and
a restore stalls nothing.
"""

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from synapseml_tpu.models import llm as J
from synapseml_tpu.models.llm import kvtier as JK
from synapseml_tpu_torch.models import llm as P
from synapseml_tpu_torch.models.llm import kvtier as PK
from synapseml_tpu_torch.models.llm import warmup as PW
from synapseml_tpu_torch.resilience import get_faults
from synapseml_tpu_torch.telemetry import get_registry
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


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


@pytest.fixture
def faults():
    """The port's process-wide fault registry, cleared and seeded around
    each test."""
    reg = get_faults()
    reg.clear()
    reg.seed(20260803)
    yield reg
    reg.clear()


def _prompts(n, length, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 512, (n, length)).astype(np.int32)


def _metric(name, **labels):
    m = get_registry().get(name)
    return 0.0 if m is None else m.value(**labels)


def _rows(rng, layers=2, span=6, kh=2, dh=4, dtype="float32"):
    """(port rows: torch tensors, reference rows: numpy) with equal bits."""
    port, ref = [], []
    for _ in range(layers):
        pr, rr = {}, {}
        for k in ("k", "v"):
            a = rng.standard_normal((span, kh, dh)).astype(np.float32)
            if dtype == "bfloat16":
                rr[k] = a.astype(ml_dtypes.bfloat16)
                pr[k] = torch.from_numpy(
                    rr[k].view(np.int16).copy()).view(torch.bfloat16)
            else:
                rr[k] = a
                pr[k] = torch.from_numpy(a.copy())
        port.append(pr)
        ref.append(rr)
    return port, ref


def _bits(t):
    """A port tensor's bits (bf16 as int16)."""
    t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _engine(tm, name, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 96)
    kw.setdefault("min_prefix", 8)
    return P.SlotEngine(tm, name=name, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the arena
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_arena_roundtrip_bit_exact(dtype):
    rng = np.random.default_rng(1)
    arena = PK.HostKVArena(1 << 20, name=f"pt-arena-{dtype}")
    rows, ref_rows = _rows(rng, span=8, dtype=dtype)
    ids = np.arange(1, 9, dtype=np.int32)
    key = arena.put(ids, rows)
    got = arena.fetch(key, 8)
    for r, g in zip(rows, got):
        assert g["k"].dtype == r["k"].dtype
        np.testing.assert_array_equal(_bits(r["k"]), _bits(g["k"]))
        np.testing.assert_array_equal(_bits(r["v"]), _bits(g["v"]))
    np.testing.assert_array_equal(_bits(rows[0]["k"][:3]),
                                  _bits(arena.fetch(key, 3)[0]["k"]))
    # the same bytes as the reference's arena: a bf16 entry is half an
    # f32 one (uint16 bit patterns), ids stored once
    ja = JK.HostKVArena(1 << 20, name=f"pt-arena-ref-{dtype}")
    ja.put(ids, ref_rows)
    assert arena.bytes_resident == ja.bytes_resident
    assert arena.bytes_resident == (2 * 2 * 8 * 2 * 4
                                    * (2 if dtype == "bfloat16" else 4)
                                    + ids.nbytes)


def test_arena_lru_pressure_drops_oldest():
    rng = np.random.default_rng(3)
    rows, _ = _rows(rng, span=4)
    per = sum(r[k].numel() * 4 for r in rows for k in ("k", "v")) + 4 * 4
    arena = PK.HostKVArena(per * 2 + 8, name="pt-arena-lru")
    k1 = arena.put([1, 2, 3, 4], _rows(rng, span=4)[0])
    k2 = arena.put([5, 6, 7, 8], _rows(rng, span=4)[0])
    arena.fetch(k1, 1)                  # k2 becomes the LRU tail
    k3 = arena.put([9, 10, 11, 12], _rows(rng, span=4)[0])
    assert len(arena) == 2
    with pytest.raises(KeyError):
        arena.fetch(k2, 1)
    arena.fetch(k1, 1), arena.fetch(k3, 1)
    assert _metric("kvtier_arena_evictions_total", engine="pt-arena-lru",
                   reason="pressure") == 1.0


def test_arena_over_budget_entry_refused_whole():
    rng = np.random.default_rng(4)
    arena = PK.HostKVArena(64, name="pt-arena-tiny")
    assert arena.put([1, 2, 3, 4], _rows(rng, span=4)[0]) is None
    assert len(arena) == 0 and arena.bytes_resident == 0


def test_arena_longer_spill_supersedes_prefix():
    rng = np.random.default_rng(5)
    arena = PK.HostKVArena(1 << 20, name="pt-arena-sup")
    arena.put([1, 2, 3, 4], _rows(rng, span=4)[0])
    assert arena.put([1, 2, 3, 4], _rows(rng, span=4)[0]) is None
    assert len(arena) == 1
    k2 = arena.put([1, 2, 3, 4, 5, 6], _rows(rng, span=6)[0])
    assert k2 is not None and len(arena) == 1
    assert arena.longest_prefix([1, 2, 3, 4, 5, 6, 7]) == (k2, 6)
    assert arena.longest_prefix([1, 2, 3], tenant="other") == (None, 0)
    assert _metric("kvtier_arena_evictions_total", engine="pt-arena-sup",
                   reason="superseded") == 1.0


def test_arena_corrupt_entry_dropped_at_fetch(faults):
    rng = np.random.default_rng(6)
    faults.inject("kvtier.spill", "corrupt", times=1)
    arena = PK.HostKVArena(1 << 20, name="pt-arena-rot")
    key = arena.put([1, 2, 3, 4], _rows(rng, span=4)[0])
    with pytest.raises(PK.ChecksumError):
        arena.fetch(key, 4)
    assert len(arena) == 0
    with pytest.raises(KeyError):
        arena.fetch(key, 4)
    assert _metric("kvtier_arena_evictions_total", engine="pt-arena-rot",
                   reason="corrupt") == 1.0
    arena.fetch(arena.put([1, 2, 3, 4], _rows(rng, span=4)[0]), 4)


# ---------------------------------------------------------------------------
# the transfer codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codec_bytes_equal_reference_and_cross_unpack(dtype):
    rng = np.random.default_rng(7)
    rows, ref_rows = _rows(rng, layers=3, span=5, dtype=dtype)
    ids = _prompts(1, 5, seed=7)[0]
    blob = PK.pack_kv_transfer(ids, rows, session="conv", tenant="t1")
    ref = JK.pack_kv_transfer(ids, ref_rows, session="conv", tenant="t1")
    assert blob == ref
    assert PK.token_prefix_hash(ids) == JK.token_prefix_hash(ids)
    mine = PK.unpack_kv_transfer(ref)                  # theirs → port
    theirs = JK.unpack_kv_transfer(blob)               # port → theirs
    assert mine.ids == theirs.ids == [int(t) for t in ids]
    assert (mine.session, mine.tenant) == ("conv", "t1")
    for m, t, r in zip(mine.rows, theirs.rows, rows):
        for k in ("k", "v"):
            np.testing.assert_array_equal(_bits(m[k]), _bits(r[k]))
            np.testing.assert_array_equal(
                np.asarray(t[k]).view(np.int16 if dtype == "bfloat16"
                                      else np.float32), _bits(r[k]))
    bad = bytearray(blob)
    bad[-3] ^= 0xFF
    with pytest.raises(PK.ChecksumError):
        PK.unpack_kv_transfer(bytes(bad))
    with pytest.raises(ValueError):
        PK.unpack_kv_transfer(b"not a frame")


# ---------------------------------------------------------------------------
# the session journal
# ---------------------------------------------------------------------------

def test_journal_begin_append_replay(tmp_path):
    j = PK.SessionJournal(str(tmp_path), name="pt-jnl")
    j.begin("s1", [1, 2, 3], 10)
    j.append_tokens("s1", [7])
    j.append_tokens("s1", [8, 9])
    st = j.replay("s1")
    assert st.prompt == [1, 2, 3] and st.committed == [7, 8, 9]
    assert st.max_new == 10 and st.truncated == 0
    assert st.ids == [1, 2, 3, 7, 8, 9]
    assert j.sessions() == ["s1"]
    assert j.replay("s1", tenant="other") is None
    j.begin("s1", st.ids + [4], 6)
    st2 = j.replay("s1")
    assert st2.committed == [] and st2.prompt[-1] == 4
    j.drop("s1")
    assert j.replay("s1") is None and j.sessions() == []


def test_journal_torn_tail_truncates_to_last_valid_record(tmp_path, faults):
    j = PK.SessionJournal(str(tmp_path), name="pt-jnl-torn")
    j.begin("s", [1, 2], 8)
    j.append_tokens("s", [5])
    path = j.path("s")
    good = os.path.getsize(path)
    with open(path, "ab") as f:
        f.write(b"deadbeef {\"op\": \"tok")     # torn mid-record
    assert j.replay("s").committed == [5]
    assert os.path.getsize(path) == good
    j.append_tokens("s", [6])
    with open(path, "r+b") as f:                # a corrupt middle record
        f.seek(good + 12)
        f.write(b"\xff")
    assert j.replay("s").committed == [5]
    # an armed corrupt fault at the append site is survivable
    faults.inject("kvtier.journal_append", "corrupt", times=1)
    j.append_tokens("s", [7])
    assert j.replay("s").committed == [5]
    j.append_tokens("s", [8])
    assert j.replay("s").committed == [5, 8]


def test_journal_compaction_bounds_the_file(tmp_path):
    j = PK.SessionJournal(str(tmp_path), max_bytes_per_session=512,
                          name="pt-jnl-cap")
    j.begin("s", [1, 2, 3], 64)
    for t in range(40):
        j.append_tokens("s", [t % 7 + 1])
    assert os.path.getsize(j.path("s")) <= 512 + 64
    st = j.replay("s")
    assert len(st.committed) == 40 and st.truncated == 0
    j.retire("s")
    with open(j.path("s"), "rb") as f:
        assert f.read().count(b"\n") == 1
    assert j.replay("s").committed == st.committed


def test_journal_oversize_conversation_truncates_marked(tmp_path):
    j = PK.SessionJournal(str(tmp_path), max_bytes_per_session=256,
                          name="pt-jnl-trunc")
    j.begin("s", list(range(1, 120)), 8)
    j.append_tokens("s", [7])
    j.compact("s")
    st = j.replay("s")
    assert st.truncated > 0
    assert len(st.ids) <= max(16, 256 // 8)
    ref = JK.SessionJournal(str(tmp_path), name="pt-jnl-trunc-ref")
    assert ref.replay("s").__dict__ == st.__dict__


def test_journal_unrelated_files_ignored(tmp_path):
    (tmp_path / "notes.txt").write_text("not a journal")
    (tmp_path / "garbage.jnl").write_bytes(b"\x00\x01\x02")
    j = PK.SessionJournal(str(tmp_path), name="pt-jnl-mix")
    j.begin("s", [1], 4)
    assert j.sessions() == ["s"]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journal_replays_across_packages(tmp_path, writer):
    W, R = (PK, JK) if writer == "port" else (JK, PK)
    w = W.SessionJournal(str(tmp_path), max_bytes_per_session=512,
                         name=f"pt-jnl-x-{writer}")
    w.begin("conv", [5, 6, 7], 12, tenant="t1")
    for t in range(3):
        w.append_tokens("conv", [t + 1], tenant="t1")
    w.begin("other", [9], 3)
    w.append_tokens("other", [4])
    w.compact("other")
    with open(w.path("conv", "t1"), "ab") as f:
        f.write(b"0badc0de {\"op\"")             # a torn tail
    r = R.SessionJournal(str(tmp_path), name=f"pt-jnl-y-{writer}")
    assert r.path("conv", "t1") == w.path("conv", "t1")
    st = r.replay("conv", tenant="t1")
    assert (st.session, st.prompt, st.committed, st.max_new, st.tenant) == \
        ("conv", [5, 6, 7], [1, 2, 3], 12, "t1")
    assert r.replay("conv") is None
    assert r.replay("other").ids == [9, 4]
    assert sorted(r.sessions()) == ["conv", "other"]
    # the reader's appends go on where the writer's stopped
    r.append_tokens("conv", [4], tenant="t1")
    assert w.replay("conv", tenant="t1").committed == [1, 2, 3, 4]


# ---------------------------------------------------------------------------
# the engine's arena path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plen,spec", [(12, 0), (28, 0), (12, 4)],
                         ids=["short", "long-bucket", "spec"])
def test_engine_restore_token_exact_vs_cold(pair, faults, plen, spec):
    """A relaunched engine sharing the host arena restores a spilled span
    into a fresh slot; the continuation equals the reference's greedy
    tokens for the whole context (a cold prefill)."""
    jm, variables, tm = pair
    name = f"pt-restore-{plen}-{spec}"
    arena = PK.HostKVArena(1 << 22, name=name)
    kw = dict(spec_draft_len=spec, kv_arena=arena)
    eng1 = _engine(tm, name, **kw)
    p1 = _prompts(1, plen, seed=plen)[0]
    r1 = eng1.admit(p1, 6)
    out1 = eng1.run_to_completion()[r1.slot]
    assert len(arena) == 1 and eng1.spill_count == 1
    assert eng1.spill_bytes == 2 * 2 * (plen + 5) * 4 * 16 * 4
    p2 = np.concatenate([p1, out1, _prompts(1, 5, seed=plen + 1)[0]])
    ref = J.generate(jm, variables, p2[None], max_new_tokens=6)[0]
    eng2 = _engine(tm, name, **kw)
    ok0 = _metric("kvtier_restores_total", engine=name, source="host",
                  outcome="ok")
    r2 = eng2.admit(p2, 6)
    assert r2.reused_tokens == plen + 5            # the spilled span
    assert _metric("kvtier_restores_total", engine=name, source="host",
                   outcome="ok") == ok0 + 1
    np.testing.assert_array_equal(eng2.run_to_completion()[r2.slot], ref)
    hist = get_registry().get("kvtier_admit_latency_seconds")
    assert hist.stats(engine=name, path="restore")["count"] >= 1
    assert hist.stats(engine=name, path="cold")["count"] >= 1


def test_engine_corrupt_spill_falls_back_cold(pair, faults):
    jm, variables, tm = pair
    name = "pt-restore-rot"
    arena = PK.HostKVArena(1 << 22, name=name)
    eng1 = _engine(tm, name, kv_arena=arena)
    p1 = _prompts(1, 16, seed=40)[0]
    faults.inject("kvtier.spill", "corrupt")
    r1 = eng1.admit(p1, 6)
    out1 = eng1.run_to_completion()[r1.slot]
    p2 = np.concatenate([p1, out1, _prompts(1, 5, seed=41)[0]])
    ref = J.generate(jm, variables, p2[None], max_new_tokens=6)[0]
    eng2 = _engine(tm, name, kv_arena=arena)
    c0 = _metric("kvtier_restores_total", engine=name, source="host",
                 outcome="corrupt")
    r2 = eng2.admit(p2, 6)
    assert r2.reused_tokens == 0
    assert _metric("kvtier_restores_total", engine=name, source="host",
                   outcome="corrupt") == c0 + 1
    np.testing.assert_array_equal(eng2.run_to_completion()[r2.slot], ref)


def test_engine_arena_miss_between_probe_and_fetch_is_cold(pair):
    jm, variables, tm = pair
    name = "pt-restore-miss"
    arena = PK.HostKVArena(1 << 22, name=name)
    eng1 = _engine(tm, name, kv_arena=arena)
    p1 = _prompts(1, 16, seed=42)[0]
    r1 = eng1.admit(p1, 6)
    p2 = np.concatenate([p1, eng1.run_to_completion()[r1.slot]])

    class _Racy:
        """An arena whose entry vanishes after the probe."""
        def longest_prefix(self, ids, tenant="default"):
            key, lcp = arena.longest_prefix(ids, tenant=tenant)
            arena.clear()
            return key, lcp

        def fetch(self, key, length, tenant="default"):
            return arena.fetch(key, length, tenant=tenant)

        def put(self, *a, **k):
            return None

    ref = J.generate(jm, variables, p2[None], max_new_tokens=4)[0]
    eng2 = _engine(tm, name, kv_arena=_Racy())
    m0 = _metric("kvtier_restores_total", engine=name, source="host",
                 outcome="miss")
    r2 = eng2.admit(p2, 4)
    assert r2.reused_tokens == 0
    assert _metric("kvtier_restores_total", engine=name, source="host",
                   outcome="miss") == m0 + 1
    np.testing.assert_array_equal(eng2.run_to_completion()[r2.slot], ref)


def test_engine_preempt_resume_with_arena_token_exact(pair):
    """Mid-decode eviction (retirement + spill), another request churning
    the freed slot, then resume (restore + continue): the reference's
    greedy continuation."""
    jm, variables, tm = pair
    name = "pt-preempt"
    arena = PK.HostKVArena(1 << 22, name=name)
    eng = _engine(tm, name, kv_arena=arena)
    p = _prompts(1, 14, seed=50)[0]
    ref = J.generate(jm, variables, p[None], max_new_tokens=12)[0]
    r = eng.admit(p, 12)
    for _ in range(4):
        eng.step()
    assert eng.preempt_slot() == r.slot
    ticket = eng.preempt(r.slot)
    assert eng.preempt(r.slot) is None
    assert _metric("kvtier_spills_total", engine=name, kind="preempt") == 1
    eng.admit(_prompts(1, 10, seed=51)[0], 4)
    eng.admit(_prompts(1, 10, seed=52)[0], 4)   # both slots overwritten
    eng.run_to_completion()
    ok0 = _metric("kvtier_restores_total", engine=name, source="host",
                  outcome="ok")
    slot2 = eng.resume(ticket)
    assert _metric("kvtier_restores_total", engine=name, source="host",
                   outcome="ok") == ok0 + 1
    eng.run_to_completion()
    np.testing.assert_array_equal(eng.generated_ids(slot2), ref)


def test_engine_resume_on_fresh_engine(pair):
    """Without an arena or a device prefix, resume rebuilds the span cold
    from the ticket's ids: still the reference's tokens."""
    jm, variables, tm = pair
    eng1 = _engine(tm, "pt-preempt-cold")
    p = _prompts(1, 14, seed=52)[0]
    ref = J.generate(jm, variables, p[None], max_new_tokens=10)[0]
    r = eng1.admit(p, 10)
    for _ in range(3):
        eng1.step()
    ticket = eng1.preempt(r.slot)
    eng2 = _engine(tm, "pt-preempt-cold2")
    slot2 = eng2.resume(ticket)
    eng2.run_to_completion()
    np.testing.assert_array_equal(eng2.generated_ids(slot2), ref)


def test_engine_malformed_ticket_refused(pair):
    eng = _engine(pair[2], "pt-preempt-bad",
                  kv_arena=PK.HostKVArena(1 << 20, name="pt-preempt-bad"))
    with pytest.raises(ValueError):
        eng.resume({"ids": [], "kv_len": 0, "generated": 0, "max_new": 4})
    with pytest.raises(ValueError):
        eng.resume({"ids": [1, 2, 3], "kv_len": 3, "generated": 1,
                    "max_new": 4})


def test_lattice_covers_restore_with_no_stalls(pair):
    """An arena engine's lattice has the reference's rows, restore
    included (one per bucket), and a warm plane restores without a
    stall; a plain engine's lattice has no restore row."""
    jm, variables, tm = pair
    jeng = J.SlotEngine(jm, variables, n_slots=2, max_len=64,
                        attention_backend="dense",
                        kv_arena=JK.HostKVArena(1 << 20, name="pt-lat-ref"))
    ref = [(s.kind, s.key) for s in J.program_lattice(jeng)
           if s.kind in ("prefill", "restore", "prefix_copy")]
    arena = PK.HostKVArena(1 << 22, name="pt-lattice")
    eng = _engine(tm, "pt-lattice", max_len=64, attention_backend="dense",
                  kv_arena=arena, warmup="sync")
    got = [(s.kind, s.key) for s in PW.program_lattice(eng)
           if s.kind in ("prefill", "restore", "prefix_copy")]
    assert got == ref and ("restore", "restore_b8") in got
    plain = _engine(tm, "pt-lattice-plain", max_len=64)
    assert "restore" not in {s.kind for s in PW.program_lattice(plain)}
    p1 = _prompts(1, 12, seed=60)[0]
    r1 = eng.admit(p1, 4)
    out1 = eng.run_to_completion()[r1.slot]
    eng2 = _engine(tm, "pt-lattice", max_len=64, attention_backend="dense",
                   kv_arena=arena, warmup="sync")
    p2 = np.concatenate([p1, out1, [7, 8, 9]]).astype(np.int32)
    r2 = eng2.admit(p2, 4)
    assert r2.reused_tokens == 15
    eng2.run_to_completion()
    snap = eng2.compile_plane.snapshot()
    assert snap["stalls"] == 0 and snap["replays"] == eng2.steps_run
