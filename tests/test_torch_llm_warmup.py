"""The port's compile plane (``models/llm/warmup.py``) against the JAX
package's, on the CPU.

CPU, ``LlamaConfig.tiny(num_layers=2, max_len=64)`` in f32, parameters
from the JAX model:

- the lattice holds the reference's (kind, S) rows and prefill buckets
  for the same static config, with the reference's span buckets folded
  away (K3 reads each slot's span on the device);
- every engine method that runs the model or touches the cache runs a
  lattice program or is explicitly exempt (the counterpart of the
  reference's jit entry-point sweep);
- warm-up leaves the cache bitwise unchanged;
- a ``warmup="sync"`` engine is token-exact against the JAX
  ``SlotEngine`` and the port's eager engine, plain and speculative, with
  no stall and one replay per step; on the CPU the plane dispatches the
  same static buffers as the card, eagerly;
- the packed step program gives, bit for bit, the logits of the model
  call the eager step made before it;
- ``reset`` zeroes the cache in place.

The graphs themselves are held on a card by
``tests/test_torch_llm_cuda.py`` (marked ``gpu``).
"""

import ast
import dataclasses
import inspect
import textwrap
import threading

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.models import llm as J
from synapseml_tpu_torch.kernels import launches
from synapseml_tpu_torch.models import llm as P
from synapseml_tpu_torch.models.llm import slots as PS
from synapseml_tpu_torch.models.llm import warmup as PW
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


@pytest.fixture(scope="module")
def pair():
    jcfg = J.LlamaConfig.tiny(num_layers=2, max_len=64, dtype=jnp.float32)
    tcfg = P.LlamaConfig.tiny(num_layers=2, max_len=64, dtype=torch.float32)
    jm = J.LlamaModel(jcfg)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))
    params = jax.tree.map(np.asarray, nn.meta.unbox(variables))
    tm = P.LlamaModel(tcfg, device="cpu")
    tm.load_state_dict(P.params_from_reference(params, tcfg, "cpu"))
    return jm, variables, tm


def _engine(tm, **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("max_len", 64)
    return P.SlotEngine(tm, device=kw.pop("device", "cpu"), **kw)


def _prompts(seed, lengths=(9, 15, 12), period=5):
    """Repeated-phrase prompts, so that speculative drafts hit."""
    rng = np.random.default_rng(seed)
    return [np.tile(rng.integers(1, 512, period), 4)[:n].astype(np.int32)
            for n in lengths]


def _drive(eng, prompts, new=(12, 10, 8)):
    """Two requests, three steps, a third admitted mid-flight, run to the
    end → each request's generated ids."""
    r = [eng.admit(prompts[0], new[0]), eng.admit(prompts[1], new[1])]
    for _ in range(3):
        eng.step()
    r.append(eng.admit(prompts[2], new[2]))
    eng.run_to_completion()
    return [np.asarray(eng.generated_ids(x.slot)) for x in r]


def _row(kind, key):
    """(kind, width): S for a decode/verify step, the bucket of a
    prefill, 0 for the prefix copy — read from the program key."""
    if kind == "decode":
        return kind, 1
    if kind == "verify":
        return kind, int(key.split("_s")[1].split("_")[0])
    if kind == "prefill":
        return kind, int(key.split("_b")[1])
    return kind, 0


@pytest.mark.parametrize("spec", [0, 4, 7])
@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_lattice_rows_equal_the_reference(pair, backend, spec):
    jm, variables, tm = pair
    jeng = J.SlotEngine(jm, variables, n_slots=2, max_len=64,
                        spec_draft_len=spec,
                        attention_backend=("interpret" if backend == "paged"
                                           else "dense"))
    ref = list(dict.fromkeys(_row(s.kind, s.key)
                             for s in J.program_lattice(jeng)))
    eng = _engine(tm, n_slots=2, spec_draft_len=spec,
                  attention_backend=backend)
    specs = PW.program_lattice(eng)
    assert [_row(s.kind, s.key) for s in specs] == ref
    for s in specs:
        assert s.S == (_row(s.kind, s.key)[1]
                       if s.kind in ("decode", "verify") else 0)
    assert {s.kind for s in specs} == (
        {"decode", "prefix_copy", "prefill"} | ({"verify"} if spec else set()))


def _cache_methods():
    """SlotEngine methods whose body calls ``self.model`` or reads
    ``self.cache``."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(PS.SlotEngine)))
    found = set()
    for fn in tree.body[0].body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Attribute) and node.attr in
                    ("cache", "model") and isinstance(node.value, ast.Name)
                    and node.value.id == "self"):
                found.add(fn.name)
    return found


def test_every_program_method_is_in_the_lattice_or_exempt(pair):
    """The counterpart of the reference's jit entry-point sweep: a new
    engine method that runs the model or touches the cache fails here
    until ``warmup.PROGRAM_METHODS`` (a program of the lattice) or
    ``warmup.EXEMPT_METHODS`` lists it."""
    found = _cache_methods()
    listed = set(PW.PROGRAM_METHODS) | set(PW.EXEMPT_METHODS)
    assert found == listed, (
        f"SlotEngine methods that touch the model or cache {sorted(found)} "
        f"!= listed {sorted(listed)}: register new programs with the "
        "warm-up lattice (models/llm/warmup.py)")
    assert not set(PW.PROGRAM_METHODS) & set(PW.EXEMPT_METHODS)
    # an engine with a host KV arena runs every kind (restore included)
    eng = _engine(pair[2], spec_draft_len=4,
                  kv_arena=P.HostKVArena(1 << 20, name="pt-sweep-arena"))
    kinds = {s.kind for s in PW.program_lattice(eng)}
    assert kinds == {k for ks in PW.PROGRAM_METHODS.values() for k in ks}


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_warmup_leaves_the_cache_bitwise_unchanged(pair, backend):
    eng = _engine(pair[2], spec_draft_len=4, attention_backend=backend)
    g = torch.Generator().manual_seed(1)
    for c in eng.cache:
        for t in (c["k"], c["v"]):
            t.copy_(torch.randn(t.shape, generator=g))
    before = [(c["k"].clone(), c["v"].clone()) for c in eng.cache]
    plane = PW.CompilePlane(eng)
    assert plane.status == "cold" and not plane.admission_ready(9)
    plane.start(background=False)
    assert plane.is_warm and plane.admission_ready(9)
    assert plane.programs_warm == len(PW.program_lattice(eng)) == 9
    for c, (k, v) in zip(eng.cache, before):
        assert torch.equal(c["k"], k) and torch.equal(c["v"], v)
    snap = plane.snapshot()
    assert snap["state"] == "warm" and snap["stalls"] == 0
    assert snap["replays"] == 0 and snap["pool_bytes"] == 0
    assert snap["warmup_seconds"] >= 0


@pytest.mark.parametrize("spec", [0, 4])
def test_sync_engine_token_exact(pair, spec):
    """warmup='sync' against the JAX SlotEngine and the port's eager
    engine on the same requests."""
    jm, variables, tm = pair
    prompts = _prompts(spec)
    ref = _drive(J.SlotEngine(jm, variables, n_slots=3, max_len=64,
                              spec_draft_len=spec), prompts)
    eager = _drive(_engine(tm, spec_draft_len=spec), prompts)
    eng = _engine(tm, spec_draft_len=spec, warmup="sync")
    out = _drive(eng, prompts)
    for a, b, c in zip(ref, eager, out):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c, a)
    plane = eng.compile_plane
    assert plane.stalls == 0 and plane.replays == eng.steps_run > 0
    if spec:
        assert eng.spec_steps > 0


def test_warmup_values_are_normalized(pair):
    tm = pair[2]
    for off in (None, False, "off"):
        assert _engine(tm, warmup=off).compile_plane is None
    for on in (True, "sync"):
        assert _engine(tm, warmup=on).compile_plane.status == "warm"
    eng = _engine(tm, warmup="background")
    assert eng.compile_plane.wait(60) and eng.compile_plane.status == "warm"
    assert eng.compile_plane.ready_at is not None
    with pytest.raises(ValueError, match="warmup='lazy'"):
        _engine(tm, warmup="lazy")


def test_cold_plane_counts_stalls(pair):
    """A plane that never warmed captures (here: runs) each program the
    first time the serving loop needs it, counting a stall each time;
    the tokens do not change."""
    tm = pair[2]
    prompts = _prompts(3)
    want = _drive(_engine(tm, spec_draft_len=4), prompts)
    eng = _engine(tm, spec_draft_len=4)
    eng.compile_plane = PW.CompilePlane(eng)
    assert not eng.admission_ready(9)
    out = _drive(eng, prompts)
    for a, b in zip(want, out):
        np.testing.assert_array_equal(b, a)
    plane = eng.compile_plane
    # one prefill bucket (8 < 9..15 <= 16), the decode step and each
    # verify width the drafts reached
    widths = {int(k.split("_s")[1]) for k in plane._warmed
              if k.startswith("verify")}
    assert plane._warmed == ({"prefill_b16", "decode_paged"}
                             | {f"verify_paged_s{s}" for s in widths})
    assert plane.stalls == len(plane._warmed)
    assert plane.replays == eng.steps_run


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_step_program_gives_the_previous_call_bitwise(pair, backend):
    """The packed step input and the forward's causal mask moved; the
    logits of a decode step and the argmax of a verify step stay bit for
    bit those of the model call the eager step made before (tokens,
    positions li..li+S-1, int32 offsets, a bool slot mask)."""
    tm = pair[2]
    eng = _engine(tm, attention_backend=backend)
    for p in _prompts(5)[:2]:
        eng.admit(p, 20)
    for _ in range(2):
        eng.step()
    lengths = eng._decode_step_args()
    rng = np.random.default_rng(0)
    for S in (1, 4):
        tokens = rng.integers(1, 512, (eng.n_slots, S)).astype(np.int32)
        caches = [[{k: t.clone() for k, t in c.items()} for c in eng.cache]
                  for _ in range(2)]
        li = torch.as_tensor((lengths - 1).astype(np.int32))
        positions = li[:, None] + torch.arange(S, dtype=torch.int32)[None]
        with torch.no_grad():
            old, _ = tm(torch.as_tensor(tokens), positions=positions,
                        cache=caches[0], cache_index=li,
                        slot_mask=torch.as_tensor(eng.active),
                        attention_backend=eng.attention_backend)
            new = PS.step_program(
                tm, caches[1], torch.as_tensor(eng._pack_step(tokens,
                                                              lengths)),
                eng.attention_backend)
        want = old[:, 0] if S == 1 else torch.argmax(old, -1).int()
        assert torch.equal(new, want)
        for a, b in zip(*caches):
            assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def test_reset_zeroes_the_cache_in_place(pair):
    eng = _engine(pair[2], warmup="sync")
    prompts = _prompts(8)
    first = _drive(eng, prompts)
    ptrs = [(c["k"].data_ptr(), c["v"].data_ptr()) for c in eng.cache]
    eng.reset()
    assert [(c["k"].data_ptr(), c["v"].data_ptr())
            for c in eng.cache] == ptrs
    assert all(not c["k"].any() and not c["v"].any() for c in eng.cache)
    again = _drive(eng, prompts)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(b, a)
    assert eng.compile_plane.replays == eng.steps_run


def test_launch_recording_defers_counts_to_replays():
    launches.reset()
    with launches.recording() as rec:
        launches.count("k", S=1)
        launches.count("k", S=1)
    assert launches.BY_SHAPE == {} and rec == {"k[S=1]": 2}
    launches.count("k", S=1)
    launches.add(rec)
    launches.add(rec)
    assert launches.BY_SHAPE == {"k[S=1]": 5}
    launches.reset()


def test_launch_recording_holds_only_its_own_thread():
    """Launches another thread makes while a graph captures count at
    once, not at the capturing graph's replays."""
    launches.reset()
    with launches.recording() as rec:
        launches.count("k", S=2)
        t = threading.Thread(target=launches.count, args=("k",),
                             kwargs={"S": 1})
        t.start()
        t.join()
    assert rec == {"k[S=2]": 1} and launches.BY_SHAPE == {"k[S=1]": 1}
    launches.reset()


def _gated_lattice(monkeypatch, gate, fail=False):
    """``program_lattice`` whose first program waits for ``gate`` (and
    then raises, with ``fail``)."""
    real = PW.program_lattice

    def lattice(engine):
        specs = real(engine)
        run = specs[0].run

        def held(plane):
            assert gate.wait(30)
            if fail:
                raise RuntimeError("warm-up broke")
            return run(plane)
        specs[0] = dataclasses.replace(specs[0], run=held)
        return specs
    monkeypatch.setattr(PW, "program_lattice", lattice)


def test_background_warmup_holds_admission(pair, monkeypatch):
    """``warmup="background"`` returns at once with the plane warming on
    its own thread; no prompt is admission-ready until the whole lattice
    is warm, then the engine is token-exact against the eager one."""
    tm = pair[2]
    prompts = _prompts(2)
    want = _drive(_engine(tm, spec_draft_len=4), prompts)
    gate = threading.Event()
    _gated_lattice(monkeypatch, gate)
    eng = _engine(tm, spec_draft_len=4, warmup="background")
    plane = eng.compile_plane
    assert plane.status == "warming" and plane.ready_at is None
    assert not any(eng.admission_ready(n) for n in (1, 9, 40))
    assert plane.snapshot()["state"] == "warming"
    gate.set()
    assert plane.wait(60) and eng.admission_ready(9)
    for a, b in zip(want, _drive(eng, prompts)):
        np.testing.assert_array_equal(b, a)
    assert plane.stalls == 0 and plane.replays == eng.steps_run


def test_failed_background_warmup_admits_nothing(pair, monkeypatch):
    gate = threading.Event()
    _gated_lattice(monkeypatch, gate, fail=True)
    eng = _engine(pair[2], warmup="background")
    gate.set()
    with pytest.raises(RuntimeError, match="warm-up failed"):
        eng.compile_plane.wait(60)
    snap = eng.compile_plane.snapshot()
    assert snap["state"] == "failed" and "warm-up broke" in snap["error"]
    assert not eng.admission_ready(9)
