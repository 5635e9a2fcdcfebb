"""Measured autotuning harness + fitted collective cost model: the
measurement half of the port's self-tuning plane.

The PyTorch port of the JAX package's ``telemetry/autotune.py``:

- a :class:`TuneSpace` names a search space, the port's entry point its
  candidates run through (held by :func:`resolve_entry_point` to
  :data:`TUNABLE_ENTRY_POINTS`: the port has no jit wrapper to check),
  and a ``build()`` hook producing the concrete ``(candidate config,
  runner)`` trials for this process;
- :meth:`Autotuner.run` runs every candidate once (a build or a check is
  not the measurement), times them through
  :meth:`~.gangplane.StepProfiler.measure`'s alternating min-of-blocks
  protocol and persists the winner into the
  :mod:`~synapseml_tpu_torch.telemetry.tunetable` under the device the
  space ran on (``autotune_trials_total{space,outcome}`` + flight events,
  a roofline block per winner);
- :func:`fit_alpha_beta` and :class:`CollectiveCostModel`: the α-β fit
  of collective timings (pure arithmetic), which the collective planner
  consults (``COST_MODEL_SPACE``).

The builtin spaces tune the port's own kernels: ``gbdt_hist_geometry``
(K1/K2's ``hist_rows_kernel`` features per block and tile),
``paged_attn_variant`` (K3's split or single kernel) and
``llm_bucket_grid`` (the engine's prefill bucket floor); and
``int8_codec_chunk``, the collectives' int8 codec chunk (the JAX
package's ``int8_chunk``), which ``resolve_collective_config`` consults.  A kernel
space's runner times its launches' device time with CUDA events on a
card (the runner returns seconds, which :meth:`StepProfiler.measure`
trusts) and the host clock on the CPU, where the plain versions run:
the table keys both by the device, so no CPU number passes for the
card's.  Before it is timed, every kernel candidate is held against the
plain version (``check=True``): a candidate that differs raises.

The honesty rule is the table's: an empty candidate set records
NOTHING.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import threading
import time
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple)

from .flight import record as flight_record
from .gangplane import StepProfiler
from .registry import get_registry
from .tunetable import TunePlane, geometry_key, get_tuneplane

__all__ = [
    "AUTOTUNE_METRICS", "TuneSpace", "Autotuner", "TUNABLE_ENTRY_POINTS",
    "register_space", "registered_spaces", "resolve_entry_point",
    "fit_alpha_beta", "CollectiveCostModel", "COST_MODEL_SPACE",
    "COST_MODEL_GEOMETRY",
]

#: metrics this module (and the table loader) own
AUTOTUNE_METRICS = frozenset({
    "autotune_trials_total",
    "autotune_table_consults_total",
})

#: the tuning-table space/geometry a fitted collective model records
#: under (the collective planner consults it)
COST_MODEL_SPACE = "collective_cost_model"
COST_MODEL_GEOMETRY = "link=ici"

#: the port's entry points a search space may time, per module: each is
#: a module-level callable whose launches the space's knob changes
TUNABLE_ENTRY_POINTS = {
    "synapseml_tpu_torch.models.gbdt.hist": frozenset({
        "build_hist_nodes_limbs"}),
    "synapseml_tpu_torch.models.llm.paged_attn": frozenset({
        "paged_decode_attention"}),
    "synapseml_tpu_torch.models.llm.slots": frozenset({"SlotEngine"}),
    "synapseml_tpu_torch.parallel.compression": frozenset({
        "int8_roundtrip"}),
}


def resolve_entry_point(spec: str):
    """``"pkg.mod:fn"`` → the callable, verified to be one of the port's
    registered tunable entry points (:data:`TUNABLE_ENTRY_POINTS`) and a
    module-level callable of that module.  Raises ``ValueError``
    otherwise — a search space can never time something nobody
    registered."""
    mod_name, _, fn_name = str(spec).partition(":")
    if not mod_name or not fn_name:
        raise ValueError(f"entry point {spec!r}: want 'module:function'")
    registered = TUNABLE_ENTRY_POINTS.get(mod_name)
    if registered is None or fn_name not in registered:
        raise ValueError(
            f"entry point {spec!r} is not in TUNABLE_ENTRY_POINTS — "
            "register it (telemetry/autotune.py) before tuning through it")
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, fn_name, None)
    if fn is None or not callable(fn):
        raise ValueError(f"entry point {spec!r} did not resolve to a "
                         "module-level callable")
    return fn


@dataclasses.dataclass(frozen=True)
class TuneSpace:
    """One registered search space.

    ``build(**ctx)`` returns ``(geometry, trials)`` where ``geometry``
    is the :func:`~synapseml_tpu_torch.telemetry.tunetable.geometry_key`
    the winner is recorded under (and the one the construction site
    consults with), and ``trials`` is a list of ``(candidate_config,
    runner)`` pairs — ``runner()`` runs the entry point with the
    candidate applied until done, and may return its own seconds.  An
    optional third element ``cost()`` returns a counted cost dict
    (``flops``/``bytes_accessed``), carried on the trial's flight event
    and the winner's roofline block.  An EMPTY trial list means nothing
    is measurable here — the harness claims nothing.

    ``ctx`` parameterizes the geometry and ``device`` (a test tunes the
    exact tiny geometry its engine will consult with, on the CPU); the
    winner is recorded under ``ctx["device"]``'s kind.
    """
    name: str
    entry_point: str
    build: Callable[..., Tuple[str, List[tuple]]]
    description: str = ""


_SPACES: Dict[str, TuneSpace] = {}
_spaces_lock = threading.Lock()
_builtin_done = False


def register_space(space: TuneSpace) -> TuneSpace:
    with _spaces_lock:
        _SPACES[space.name] = space
    return space


def registered_spaces() -> Dict[str, TuneSpace]:
    """Name → space, builtin spaces included (registered lazily; their
    ``build`` hooks import the kernels' modules only when run)."""
    _ensure_builtin_spaces()
    with _spaces_lock:
        return dict(_SPACES)


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------

class Autotuner:
    """Enumerate → warm → measure → persist, one space at a time.

    Timing is :meth:`StepProfiler.measure`'s multi-leg protocol: every
    candidate runs once per block, leg order reversing block to block,
    statistic = per-candidate minimum across ``blocks`` blocks ("how
    fast CAN this candidate go" — contention only inflates a block).
    """

    def __init__(self, plane: Optional[TunePlane] = None,
                 blocks: int = 3):
        self._plane = plane
        self.blocks = max(1, int(blocks))
        self._c_trials = get_registry().counter(
            "autotune_trials_total",
            "autotune candidate trials, by search space and outcome "
            "(ok = measured; error = candidate raised; empty = nothing "
            "measurable on this device)", ("space", "outcome"))

    @property
    def plane(self) -> TunePlane:
        return self._plane if self._plane is not None else get_tuneplane()

    def run(self, space: TuneSpace, persist: bool = True,
            **ctx: Any) -> Optional[dict]:
        """Measure every candidate of ``space`` → result dict
        (``winner``, ``measured_ms``, per-candidate ``trials_ms``,
        ``roofline``), persisting the winner into the tuning table under
        ``ctx["device"]`` (default: the process's default device).
        ``None`` when the space has no measurable candidates here."""
        resolve_entry_point(space.entry_point)   # fail fast, pre-measure
        geometry, trials = space.build(**ctx)
        legs: Dict[str, Callable[[], Any]] = {}
        configs: Dict[str, dict] = {}
        costs: Dict[str, Optional[dict]] = {}
        for trial in trials:
            cand, runner = trial[0], trial[1]
            cost_fn = trial[2] if len(trial) > 2 else None
            label = ",".join(f"{k}={v}" for k, v in sorted(cand.items()))
            # warm first: a build or a first-call cost is not the
            # measurement; a candidate that cannot even run once is an
            # error trial, not a slow one
            try:
                runner()
            except Exception as e:
                self._c_trials.inc(1, space=space.name, outcome="error")
                flight_record("autotune_trial", space=space.name,
                              geometry=geometry, candidate=label,
                              outcome="error", error=repr(e))
                continue
            legs[label] = runner
            configs[label] = dict(cand)
            costs[label] = _safe_cost(cost_fn)
        if not legs:
            self._c_trials.inc(1, space=space.name, outcome="empty")
            flight_record("autotune_trial", space=space.name,
                          geometry=geometry, outcome="empty")
            return None

        measured = StepProfiler.measure(legs, blocks=self.blocks)
        for label, seconds in measured.items():
            self._c_trials.inc(1, space=space.name, outcome="ok")
            event = {"space": space.name, "geometry": geometry,
                     "candidate": label, "outcome": "ok",
                     "measured_ms": seconds * 1e3}
            cost = costs.get(label)
            if cost:
                event["cost_bytes"] = cost.get("bytes_accessed")
                event["cost_flops"] = cost.get("flops")
            flight_record("autotune_trial", **event)

        winner_label = min(measured, key=lambda k: measured[k])
        winner_ms = measured[winner_label] * 1e3
        result = {
            "space": space.name,
            "geometry": geometry,
            "winner": configs[winner_label],
            "measured_ms": winner_ms,
            "trial_count": len(measured),
            "trials_ms": {k: v * 1e3 for k, v in measured.items()},
            "roofline": self._winner_roofline(space.name, winner_label,
                                              measured[winner_label],
                                              costs.get(winner_label)),
        }
        if persist and self.plane.directory:
            self.plane.record(space.name, geometry, configs[winner_label],
                              winner_ms, trials=len(measured),
                              device=ctx.get("device"))
        return result

    def _winner_roofline(self, space_name: str, label: str,
                         seconds: float, cost: Optional[dict]) -> dict:
        """One StepProfiler step accounting the winner's measured time
        as compute (+ its cost-analysis entry when the candidate
        captured one) → the profiler's roofline-ready summary block."""
        prof = StepProfiler(f"autotune_{space_name}")
        prof.step_begin(0)
        prof._open["t_last"] -= seconds   # attribute the measured time
        prof.mark("compute")
        if cost:
            prof.costs[label] = dict(cost)
        prof.step_end()
        return prof.summary()

    def run_all(self, persist: bool = True,
                **ctx: Any) -> Dict[str, Optional[dict]]:
        """Every registered space, each at its default geometry on
        ``ctx`` (``device=...``)."""
        return {name: self.run(space, persist=persist, **ctx)
                for name, space in sorted(registered_spaces().items())}


def _safe_cost(cost_fn) -> Optional[dict]:
    if cost_fn is None:
        return None
    try:
        cost = cost_fn()
        return dict(cost) if cost else None
    except Exception:
        return None


# ---------------------------------------------------------------------------
# builtin search spaces
# ---------------------------------------------------------------------------

def _self_timed(fn: Callable[[], Any], device, reps: int) -> float:
    """Seconds per call of ``fn`` over ``reps`` calls: on a card, CUDA
    events around calls queued behind a ~10 ms sleep kernel, so the
    events time the device's back-to-back work and not the host's
    dispatch of it; on the CPU, the host clock."""
    import torch
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def _build_gbdt_hist_geometry(num_features: int = 28, total_bins: int = 256,
                              n_slots: int = 16, n_rows: int = 1 << 20,
                              device: Any = "cuda", check: bool = True,
                              reps: int = 5, seed: int = 0):
    """Candidates: :func:`~..models.gbdt.hist.rows_geometry_candidates`,
    every ``(fpb, tile)`` ``hist_rows_kernel`` takes at this geometry;
    runner: one K1 build (``build_hist_nodes_limbs``) over ``n_rows``
    seeded rows with slots in [-1, S), as a left child's rows are
    listed.  ``check``: every candidate's histogram must equal the plain
    version's exactly (int32 sums) before it is timed."""
    import numpy as np
    import torch
    from ..device import resolve_device
    from ..models.gbdt import hist

    dev = resolve_device(device)
    F, B, S, N = int(num_features), int(total_bins), int(n_slots), \
        int(n_rows)
    geometry = hist.hist_geometry_key(F, B, S)
    rng = np.random.default_rng(seed)
    bins_t = torch.as_tensor(rng.integers(0, B, (F, N)).astype(np.int32),
                             device=dev)
    slot = torch.as_tensor(rng.integers(-1, S, N).astype(np.int32),
                           device=dev)
    grad = torch.as_tensor(rng.normal(size=N).astype(np.float32),
                           device=dev)
    hess = torch.as_tensor(rng.uniform(0.5, 1.5, N).astype(np.float32),
                           device=dev)
    vals, _ = hist.prep_hist_vals(grad, hess, torch.ones_like(grad))
    want = (hist.build_hist_nodes_plain(bins_t, slot, vals, S, B)
            if check else None)
    trials = []
    for fpb, tile in hist.rows_geometry_candidates(F, B, S):
        def call(g=(fpb, tile)):
            return hist.build_hist_nodes_limbs(bins_t, slot, vals, S, B,
                                               geometry=g)
        if want is not None and not torch.equal(call(), want):
            raise AssertionError(
                f"gbdt_hist_geometry: (fpb={fpb}, tile={tile}) at {geometry} "
                "differs from the plain version")

        def runner(call=call):
            return _self_timed(call, dev, reps)

        trials.append(({"fpb": int(fpb), "tile": int(tile)}, runner))
    return geometry, trials


def _build_paged_attn_variant(max_len: int = 256, num_heads: int = 16,
                              num_kv_heads: int = 4, d_head: int = 64,
                              n_slots: int = 8, span: int = 1,
                              dtype: Any = "bfloat16", device: Any = "cuda",
                              check: bool = True, reps: int = 20,
                              seed: int = 0):
    """Candidates: the K3 kernels that run at ``dtype``
    (``{"variant": "split"}`` and ``{"variant": "single"}``, at f32, bf16
    and f16 alike); runner: one ``paged_decode_attention`` call
    over full spans at query width ``span``.  ``check``: each candidate
    within K3's tolerance of the plain version (f32: atol 1e-5; bf16 and
    f16: atol = rtol = 1e-2) before it is timed."""
    import numpy as np
    import torch
    from ..device import resolve_device
    from ..models.llm import paged_attn as pa

    dev = resolve_device(device)
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    geometry = pa.paged_geometry_key(max_len, num_kv_heads, d_head, dt,
                                     span)
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32), device=dev).to(dt)
    q = draw(n_slots, span, num_heads, d_head)
    if span == 1:
        q = q[:, 0].contiguous()
    k = draw(n_slots, max_len, num_kv_heads, d_head)
    v = draw(n_slots, max_len, num_kv_heads, d_head)
    spans = torch.full((n_slots,), int(max_len), dtype=torch.int32,
                       device=dev)
    want = pa.paged_decode_attention_plain(q, k, v, spans) if check \
        else None
    tol = 1e-5 if dt == torch.float32 else 1e-2
    trials = []
    for variant in pa.PAGED_VARIANTS:
        if not pa.variant_ok(variant, dt):
            continue

        def call(variant=variant):
            return pa.paged_decode_attention(q, k, v, spans, variant=variant)
        if want is not None:
            torch.testing.assert_close(
                call().float(), want.float(), atol=tol,
                rtol=0 if dt == torch.float32 else tol,
                msg=lambda m: f"paged_attn_variant {variant} at {geometry}: "
                              f"{m}")

        def runner(call=call):
            return _self_timed(call, dev, reps)

        trials.append(({"variant": variant}, runner))
    return geometry, trials


def _build_llm_bucket_grid(max_len: int = 64, num_layers: int = 2,
                           prompt_lens: Sequence[int] = (5, 11, 23),
                           candidates: Sequence[int] = (4, 8, 16),
                           device: Any = "cuda"):
    """Candidates: the bucket-grid floor (``min_bucket``); runner: an
    admit+cancel cycle over seeded prompts on a tiny engine per
    candidate — a finer grid pays less prefill padding, a coarser one
    keeps fewer programs.  The runner ends in the admissions' host
    copies, so the wall clock times the device's work."""
    import numpy as np
    import torch
    from ..device import resolve_device
    from ..models.llm import LlamaConfig, LlamaModel, SlotEngine

    dev = resolve_device(device)
    geometry = geometry_key(max_len=int(max_len))
    cfg = LlamaConfig.tiny(num_layers=int(num_layers), max_len=int(max_len),
                           dtype=torch.float32)
    model = LlamaModel(cfg, device=dev, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in prompt_lens if int(n) < max_len]
    trials = []
    for mb in candidates:
        mb = int(mb)
        if mb < 1 or mb > max_len or (mb & (mb - 1)):
            continue
        eng = SlotEngine(model, n_slots=1, max_len=max_len, min_bucket=mb,
                         name="autotune_bucket_grid", device=dev)

        def runner(eng=eng):
            for prompt in prompts:
                res = eng.admit(prompt, max_new_tokens=2)
                eng.cancel(res.slot)

        trials.append(({"min_bucket": mb}, runner))
    return geometry, trials


def _build_int8_codec_chunk(numel: Optional[int] = None,
                            candidates: Sequence[int] = (64, 128, 256, 512,
                                                         1024),
                            device: Any = "cuda", reps: int = 5):
    """Candidates: the int8 codec's chunk; runner: an encode + decode
    round trip (:func:`~..parallel.compression.int8_roundtrip`) of a
    seeded flat f32 vector, timed like the kernel spaces (CUDA events on
    a card)."""
    import numpy as np
    import torch
    from ..device import resolve_device
    from ..parallel import compression as comp

    dev = resolve_device(device)
    numel = int(numel or comp.INT8_CHUNK_NUMEL)
    geometry = geometry_key(numel=numel)
    flat = torch.as_tensor(
        np.random.default_rng(0).standard_normal(numel).astype(np.float32),
        device=dev)
    trials = []
    for chunk in candidates:
        chunk = int(chunk)
        if chunk < 8 or numel % chunk:
            continue

        def runner(chunk=chunk):
            return _self_timed(lambda: comp.int8_roundtrip(flat, chunk),
                               dev, reps)

        trials.append(({"chunk": chunk}, runner))
    return geometry, trials


def _ensure_builtin_spaces() -> None:
    global _builtin_done
    with _spaces_lock:
        if _builtin_done:
            return
        _builtin_done = True
    for space in (
        TuneSpace(
            name="gbdt_hist_geometry",
            entry_point="synapseml_tpu_torch.models.gbdt.hist:"
                        "build_hist_nodes_limbs",
            build=_build_gbdt_hist_geometry,
            description="K1/K2 hist_rows_kernel features per block and "
                        "tile"),
        TuneSpace(
            name="paged_attn_variant",
            entry_point="synapseml_tpu_torch.models.llm.paged_attn:"
                        "paged_decode_attention",
            build=_build_paged_attn_variant,
            description="K3 kernel: split (per-chunk blocks + combine) or "
                        "single (one block per kv head and slot)"),
        TuneSpace(
            name="llm_bucket_grid",
            entry_point="synapseml_tpu_torch.models.llm.slots:SlotEngine",
            build=_build_llm_bucket_grid,
            description="prefill/span bucket-grid floor (min_bucket)"),
        TuneSpace(
            name="int8_codec_chunk",
            entry_point="synapseml_tpu_torch.parallel.compression:"
                        "int8_roundtrip",
            build=_build_int8_codec_chunk,
            description="values sharing one f32 scale in the collectives' "
                        "int8 codec"),
    ):
        register_space(space)


# ---------------------------------------------------------------------------
# fitted collective cost model
# ---------------------------------------------------------------------------

def fit_alpha_beta(samples: Sequence[Tuple[float, float]]
                   ) -> Tuple[float, float]:
    """Closed-form least squares of ``t(n) = α + β·n`` over
    ``(payload_bytes, seconds)`` samples → ``(alpha_s,
    beta_s_per_byte)``.  Needs measurements at ≥ 2 distinct payload
    sizes; raises ``ValueError`` otherwise — a fit that would have to
    invent a slope is no fit (the honesty rule)."""
    pts = [(float(n), float(t)) for n, t in samples]
    if any(not math.isfinite(n) or not math.isfinite(t) for n, t in pts):
        raise ValueError("fit_alpha_beta: non-finite sample")
    if len(pts) < 2 or len({n for n, _ in pts}) < 2:
        raise ValueError(
            "fit_alpha_beta needs measurements at >= 2 distinct payload "
            f"sizes, got {len(pts)} samples")
    n = len(pts)
    mx = sum(x for x, _ in pts) / n
    my = sum(y for _, y in pts) / n
    sxx = sum((x - mx) ** 2 for x, _ in pts)
    sxy = sum((x - mx) * (y - my) for x, y in pts)
    beta = sxy / sxx
    alpha = my - beta * mx
    return alpha, beta


class CollectiveCostModel:
    """α-β pricing of collective routes (pure arithmetic; the port's
    collective planner consults it).

    Per-hop transfer time is ``t(n) = α + β·n``.  A recursive-doubling
    tree over ``w`` pow-2 ranks pays ``L = log2(w)`` serial hops of the
    full payload: ``L·(α + β·n)``; a ring all-reduce pays ``2(w-1)``
    hops of ``n/w``: ``2(w-1)·(α + β·n/w)``.  The tree wins while the
    latency term dominates; the crossover payload is::

        n* = α · (2(w-1) − L) / (β · (L − 2(w-1)/w))

    (for ``w = 2`` the bandwidth coefficients tie and the tree's single
    hop always wins — the crossover is unbounded).

    ``source`` is the provenance label: ``fitted`` = α-β from real
    measured dispatch timings; ``spec`` = a given cutoff constant (the
    fallback, whose decisions equal a fixed cutoff's).
    """

    #: "the tree always wins" sentinel cutoff (w = 2, or degenerate fits)
    UNBOUNDED = 1 << 62

    def __init__(self, alpha_s: float = 0.0,
                 beta_s_per_byte: float = 0.0,
                 source: str = "spec",
                 spec_cutoff_bytes: Optional[int] = None):
        if source not in ("fitted", "spec"):
            raise ValueError(f"cost-model source {source!r}")
        if source == "fitted":
            a, b = float(alpha_s), float(beta_s_per_byte)
            if not (math.isfinite(a) and math.isfinite(b)
                    and a >= 0.0 and b > 0.0):
                raise ValueError(
                    f"fitted cost model needs alpha >= 0 and beta > 0, got "
                    f"alpha={alpha_s!r} beta={beta_s_per_byte!r} — a flat "
                    "or negative slope cannot price bandwidth; refusing "
                    "rather than extrapolating")
        self.alpha_s = float(alpha_s)
        self.beta_s_per_byte = float(beta_s_per_byte)
        self.source = source
        self._spec_cutoff = (int(spec_cutoff_bytes)
                             if spec_cutoff_bytes is not None else None)

    @classmethod
    def fitted(cls, samples: Sequence[Tuple[float, float]]
               ) -> "CollectiveCostModel":
        a, b = fit_alpha_beta(samples)
        return cls(max(0.0, a), b, source="fitted")

    @classmethod
    def spec(cls, cutoff_bytes: int) -> "CollectiveCostModel":
        return cls(source="spec", spec_cutoff_bytes=cutoff_bytes)

    def predict_s(self, nbytes: int) -> Optional[float]:
        """Per-hop transfer seconds (fitted models only)."""
        if self.source != "fitted":
            return None
        return self.alpha_s + self.beta_s_per_byte * max(0, int(nbytes))

    def tree_cutoff_bytes(self, world: int) -> int:
        """Payloads ≤ this ride the latency-optimal tree (the planner's
        small-payload branch).  Spec models return the constant they
        were built with; fitted models derive the crossover above."""
        if self.source == "spec":
            if self._spec_cutoff is None:
                raise ValueError("spec cost model built without a cutoff")
            return self._spec_cutoff
        w = max(2, int(world))
        L = math.ceil(math.log2(w))
        ring_hops = 2 * (w - 1)
        coeff = L - ring_hops / w
        if coeff <= 0:
            return self.UNBOUNDED
        n_star = self.alpha_s * (ring_hops - L) / (self.beta_s_per_byte
                                                   * coeff)
        if not math.isfinite(n_star) or n_star >= self.UNBOUNDED:
            return self.UNBOUNDED
        return max(0, int(n_star))

    def describe(self) -> dict:
        return {"source": self.source,
                "alpha_us": self.alpha_s * 1e6,
                "beta_us_per_mib": self.beta_s_per_byte * 1e6 * (1 << 20),
                "spec_cutoff_bytes": self._spec_cutoff}
