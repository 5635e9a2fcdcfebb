"""Slotted KV cache + continuous-batching decode engine.

The PyTorch port of the JAX package's ``models/llm/slots.py``: the cache
is a fixed tensor of ``n_slots`` independent rows — ``(n_slots, max_len,
kv_heads, d_head)`` per layer — and one decode step advances every
active slot by one token.  Admission and retirement happen between steps
on the host.  The reference's jitted bodies (prefill-into-slot, decode
step, verify step, prefix copy) are methods here that update the cache
in place; the reference donates the cache to each program instead.

Mechanics, as in the reference:

- **decode step** — the vector ``cache_index`` path of
  :class:`~synapseml_tpu_torch.models.llm.model.CausalAttention` writes
  each slot's K/V at its own offset and ``slot_mask`` gates the writes so
  inactive slots' rows stay bitwise unchanged (they are live prefix-cache
  material).  ``attention_backend`` selects the read: dense (full
  ``max_len`` rows, masked) or paged (the K3 kernel,
  :mod:`~synapseml_tpu_torch.models.llm.paged_attn`: only each slot's
  live span; ``'auto'`` resolves to it whenever a geometry fits, and a
  head layout the CUDA kernel is not built for raises on the card).
- **prefill-into-slot** — the prompt is padded to a power-of-two bucket,
  its K/V lands in ONE slot row (a view of the cache, written in place)
  and the true last token's logits come back for the first sampled token.
  ``start > 0`` resumes a prefill after a prefix copy.
- **prefix reuse** — one radix index per tenant over the slots'
  contexts; on admit the engine copies the longest common prefix's K/V
  into the new slot and prefills only the tail.  Reuse is capped at
  ``len(prompt) - 1`` so the prefill always produces next-token logits.
- **retirement** — EOS or the token budget frees the slot; its K/V and
  tokens persist as prefix cache until the slot is reclaimed
  (least-recently-retired first).
- **speculative decoding** (``spec_draft_len > 0``, greedy only) — the
  per-slot :class:`~synapseml_tpu_torch.models.llm.drafter.NgramDrafter`
  proposes a span; any hit upgrades the step to a multi-token VERIFY in
  one forward, which commits the longest exact-greedy draft prefix plus
  the model's bonus token per slot.

Junk-write safety: padded prefill rows, pre-copy leftovers and rejected
verify positions only ever land at positions strictly beyond a slot's
current length; decode writes position ``q`` BEFORE attending ``<= q``,
so every attendable key was written by the slot's current occupant.

Warm-up (``warmup="sync"`` or ``"background"``) is the compile plane of
:mod:`.warmup`: it builds the kernels, captures the decode step and every
verify width as CUDA graphs over the live cache, and the steps replay
them; ``"background"`` warms on the plane's own thread and
:meth:`SlotEngine.admission_ready` holds admissions until it is done.

The serving loop (``serving.server._DecodeLoop``) reads the engine
through the reference's duck-typed hooks: ``trace_sink`` (per-slot
decode/verify outcomes), :meth:`~SlotEngine.min_remaining_tokens`,
:meth:`~SlotEngine.tokens_per_step_estimate` and the registry's
``llm_*`` series under the reference's names and labels.

The host KV tier (``kv_arena``, a :class:`~.kvtier.HostKVArena`): a
retiring or preempted slot spills its live K/V span to host RAM (a
device-side stack and one device-to-host copy), and an admission or
resume whose prompt extends a spilled span longer than any device prefix
restores it into the slot instead of prefilling it (a plain copy of the
spilled bits; every degraded outcome cold-prefills).

The tuning table (:mod:`~synapseml_tpu_torch.telemetry.tunetable`) is
consulted once, at construction, before any graph is captured: the
``paged_attn_variant`` winner for this cache's geometry and device picks
the K3 kernel every paged step launches (none: the dtype's default), and
with ``min_bucket=None`` the ``llm_bucket_grid`` winner sets the prefill
bucket floor (none: 8).  ``step_profiler`` (a
:class:`~synapseml_tpu_torch.telemetry.gangplane.StepProfiler`) times each
decode and verify step up to its one host copy as ``compute``; with its
``capture_xla`` it captures each step shape's cost once, running the eager
step on copies of the cache and of the generator.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ...telemetry import get_registry
from ...telemetry.flight import record as _flight_record
from ...telemetry.gangplane import check_profiler
from .drafter import NgramDrafter
from .generate import sample_logits
from .kvtier import ChecksumError, RadixPrefixIndex, kvtier_metrics
from .model import LlamaModel, init_cache
from .paged_attn import (VARIANT_SPACE, _itemsize, check_kernel_layout,
                         dense_read_bytes, paged_geometry,
                         paged_geometry_key, paged_read_bytes,
                         resolve_attention_backend, variant_ok)


def _next_pow2(n: int) -> int:
    """Smallest power of two >= n — the one round-up behind the verify S
    bucket and the geometry gate's widest-span pricing."""
    p = 1
    while p < n:
        p *= 2
    return p


def _prefill_program_key(pb: int) -> str:
    """Stable label of one prefill-bucket program — with
    :data:`PREFIX_COPY_KEY`, the naming contract between the engine's
    program regions and the warm-up lattice (:mod:`.warmup` imports
    them)."""
    return f"prefill_b{pb}"


#: label of the prefix-copy program
PREFIX_COPY_KEY = "prefix_copy"


def _restore_program_key(pb: int) -> str:
    """Stable label of one host-restore program (one per prefill bucket:
    a restored span is labelled by the bucket it pads to)."""
    return f"restore_b{pb}"


def step_program(model: LlamaModel, cache, inputs: torch.Tensor,
                 backend: str, variant: Optional[str] = None) -> torch.Tensor:
    """One decode (``S == 1``) or verify (``S > 1``) forward of every slot
    from the packed int32 step input ``(n_slots, S + 2)``: each row's S
    tokens, then its write offset ``li`` (the position of its first fed
    token), then its active flag.  Positions are ``li .. li + S - 1``;
    the cache is written in place and inactive rows stay bitwise
    unchanged (``slot_mask``).  → the logits ``(n_slots, V)`` f32 of a
    decode step, or a verify step's greedy continuation ``(n_slots, S)``
    int32.  ``variant`` is the paged read's K3 kernel.  The eager step and
    the CUDA graphs of :mod:`.warmup` run this same function."""
    S = inputs.shape[1] - 2
    li = inputs[:, S]
    positions = li[:, None] + torch.arange(S, dtype=torch.int32,
                                           device=inputs.device)[None]
    logits, _ = model(inputs[:, :S], positions=positions, cache=cache,
                      cache_index=li, slot_mask=inputs[:, S + 1],
                      attention_backend=backend, paged_variant=variant)
    if S == 1:
        return logits[:, 0]
    return torch.argmax(logits, dim=-1).to(torch.int32)


@dataclasses.dataclass
class AdmitResult:
    """What :meth:`SlotEngine.admit` hands back: the slot, the FIRST
    generated token (the time-to-first-token moment), whether the sequence
    already finished, how many prompt tokens came from a reused prefix,
    the prefill's last-token logits (f32 host copy), the padded prefill
    bucket and, when finished, the reason."""
    slot: int
    token: int
    finished: bool
    reused_tokens: int
    logits: np.ndarray
    bucket: int = 0
    reason: Optional[str] = None


@dataclasses.dataclass
class StepEvent:
    """One slot's outcome of a decode step."""
    slot: int
    token: int
    finished: bool
    reason: Optional[str] = None      # "eos" | "length" when finished


class SlotEngine:
    """Continuous-batching decode engine over a slotted KV cache.

    Single-threaded by contract: one serving loop owns the engine and
    interleaves :meth:`admit` and :meth:`step` freely.  Greedy output is
    token-exact with the dense-cache :func:`~.generate.generate` path.
    The cache lives on ``device`` (default ``"cuda"``; raises without a
    card unless ``device="cpu"``), which must be the model's.  ``name``
    labels the engine's registry series."""

    def __init__(self, model: LlamaModel, n_slots: int = 16,
                 max_len: Optional[int] = None, *,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, eos_id: Optional[int] = None,
                 pad_id: int = 0, min_prefix: int = 8,
                 min_bucket: Optional[int] = None, seed: int = 0,
                 name: str = "llm",
                 attention_backend: str = "auto", step_profiler=None,
                 spec_draft_len: int = 0, spec_ngram: int = 3,
                 spec_adapt: bool = True, trace_sink=None,
                 warmup: Any = "off", kv_arena=None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device} but "
                             f"device={str(device)!r}")
        if getattr(model, "tp", 1) > 1:
            # the reference's tensor-parallel decoder runs through the
            # dense generate only; its paged read has no sharded form
            raise ValueError(
                "SlotEngine serves a whole model; a model sharded over a "
                "'model' axis decodes through generate()")
        # the compile plane: 'sync' warms the whole program lattice
        # before the constructor returns (a failure raises here); 'off'
        # runs every step eagerly
        if warmup in (None, False):
            warmup = "off"
        elif warmup is True:
            warmup = "sync"
        if warmup not in ("off", "sync", "background"):
            raise ValueError(f"warmup={warmup!r}: must be 'off', 'sync', "
                             "or 'background'")
        check_profiler(step_profiler, "SlotEngine")
        #: optional StepProfiler over the decode and verify steps
        self.step_profiler = step_profiler
        self.compile_plane = None
        self.model = model
        self.cfg = model.cfg
        self.n_slots = int(n_slots)
        self.max_len = int(max_len or self.cfg.max_len)
        # the widest verify step a spec-enabled engine can launch (the
        # pow2 S bucket over pending + longest draft): the gate prices it
        spec_span = _next_pow2(1 + max(0, int(spec_draft_len)))
        self.attention_backend = resolve_attention_backend(
            attention_backend, max_len=self.max_len,
            num_heads=self.cfg.num_heads,
            num_kv_heads=self.cfg.num_kv_heads,
            d_head=self.cfg.d_head, dtype=self.cfg.dtype,
            max_query_span=spec_span)
        if self.attention_backend == "paged" and self.device.type == "cuda":
            # a head layout the kernel is not built for raises here, once:
            # the card never runs the plain version in the kernel's place
            check_kernel_layout(self.cfg.num_heads, self.cfg.num_kv_heads,
                                self.cfg.d_head, self.cfg.dtype)
        self._paged_geo = (None if self.attention_backend == "dense"
                           else paged_geometry(
                               self.max_len, self.cfg.num_heads,
                               self.cfg.num_kv_heads, self.cfg.d_head,
                               self.cfg.dtype, max_query_span=spec_span))
        #: the K3 kernel of every paged step (None: the dtype's default)
        self.paged_variant = (None if self.attention_backend == "dense"
                              else self._consult_paged_variant(spec_span))
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_id = eos_id
        self.pad_id = int(pad_id)
        self.min_prefix = max(1, int(min_prefix))
        self.name = name
        #: optional request-trace hook ``sink(slot, event, **attrs)``: the
        #: serving loop installs one mapping slots to trace ids, and the
        #: engine reports each slot's step outcome through it (``decode``
        #: with tokens=1, ``verify`` with the drafted/accepted/committed
        #: span sizes)
        self.trace_sink = trace_sink
        self.spec_draft_len = max(0, int(spec_draft_len))
        self.spec_adapt = bool(spec_adapt)
        if self.spec_draft_len and self.temperature > 0:
            raise ValueError(
                "spec_draft_len > 0 requires greedy decoding "
                "(temperature <= 0): speculative verification accepts a "
                "draft token only when it equals the model's argmax, "
                "which is only the sampling rule at temperature 0")
        self._drafter = (NgramDrafter(self.n_slots, ngram=int(spec_ngram))
                         if self.spec_draft_len else None)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self.cache = init_cache(self.cfg, self.n_slots, self.max_len,
                                self.device)
        # prompt-length buckets: powers of two from min_bucket (the tuned
        # floor, else 8, the reference's) up to max_len
        if min_bucket is None:
            min_bucket = self._consult_min_bucket()
        buckets = []
        b = max(1, int(min_bucket))
        while b < self.max_len:
            buckets.append(b)
            b *= 2
        buckets.append(self.max_len)
        self._buckets = tuple(buckets)
        # host-side slot state (one serving loop owns these, no locks)
        n = self.n_slots
        self.ctx = np.zeros((n, self.max_len), np.int32)   # incl. pending tok
        self.lengths = np.zeros(n, np.int64)               # tokens in ctx
        self.active = np.zeros(n, bool)
        self.kv_len = np.zeros(n, np.int64)                # valid K/V rows
        self._retired_at = np.full(n, -np.inf)             # reclaim recency
        self._max_new = np.zeros(n, np.int64)
        self._generated = np.zeros(n, np.int64)
        # radix prefix indices over slot contexts, ONE PER TENANT: a
        # lookup only ever matches a slot the same tenant filled
        self._radices: Dict[str, RadixPrefixIndex] = {}
        #: per-slot owning tenant (sticky through retirement)
        self._slot_tenant: List[str] = ["default"] * n
        #: slot -> tenant whose radix currently indexes the slot
        self._slot_radix: Dict[int, str] = {}
        # per-slot draft-length adaptation (AIMD over an acceptance EWMA)
        self._spec_k0 = min(2, self.spec_draft_len) if self.spec_draft_len \
            else 0
        self._spec_k = np.full(n, self._spec_k0, np.int64)
        self._spec_ewma = np.ones(n)
        reg = get_registry()
        self._m_admit = reg.counter(
            "llm_admissions_total", "sequences admitted into a slot",
            ("engine", "tenant"))
        self._m_evict = reg.counter(
            "llm_evictions_total", "sequences retired from a slot",
            ("engine", "reason", "tenant"))
        self._m_tokens = reg.counter(
            "llm_engine_tokens_total", "tokens generated by the engine",
            ("engine",))
        self._m_reuse = reg.counter(
            "llm_prefix_reuse_total", "admissions served a reused prefix",
            ("engine",))
        self._m_reuse_tok = reg.counter(
            "llm_prefix_tokens_reused_total",
            "prompt tokens copied from a cached prefix instead of "
            "prefilled", ("engine",))
        self._m_occ = reg.gauge(
            "llm_slot_occupancy", "active slots / total slots", ("engine",))
        self._m_decode_bytes = reg.gauge(
            "llm_decode_bytes_per_token",
            "decode-attention K/V bytes read per generated token this "
            "step (exact DMA ledger for the paged kernel; the full-"
            "capacity read model for dense)", ("engine", "backend"))
        self._m_spec_span = reg.histogram(
            "llm_spec_accepted_span_size",
            "tokens committed per slot per speculative verify step "
            "(accepted draft prefix + the bonus token)", ("engine",),
            buckets=(1, 2, 3, 4, 5, 6, 8, 12, 16))
        self._m_spec_hit = reg.counter(
            "llm_spec_draft_hit_total",
            "slot-steps where the n-gram drafter proposed a span",
            ("engine",))
        self._m_spec_miss = reg.counter(
            "llm_spec_draft_miss_total",
            "slot-steps where the n-gram drafter had no match (the slot "
            "rode the plain one-token step)", ("engine",))
        #: optional host KV arena (:class:`~.kvtier.HostKVArena`): retiring
        #: slots spill their live span into it, and admissions restore
        #: spilled conversations from it instead of prefilling them
        self.kv_arena = kv_arena
        self._mkv = kvtier_metrics()
        #: spills made by this engine, their bytes and host seconds (the
        #: device-side stack, the device-to-host copy and the arena's put)
        self.spill_count = 0
        self.spill_bytes = 0
        self.spill_seconds = 0.0
        #: restores from the arena and the K/V positions they wrote
        self.restore_count = 0
        self.restore_tokens = 0
        self.admissions = 0
        self.evictions = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.tokens_generated = 0
        #: cumulative decode-attention K/V bytes (the byte ledger)
        self.decode_attn_bytes = 0
        #: the same steps' K/V bytes at each slot's exact live span, which
        #: is what the CUDA kernel reads (it stops at the span, not at the
        #: ledger's tile); equal to the ledger for the dense read
        self.decode_attn_live_bytes = 0
        #: steps_run counts every engine step (plain or verify), spec_*
        #: only drafted work
        self.steps_run = 0
        self.spec_steps = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_draft_hits = 0
        self.spec_draft_misses = 0
        self._tps_ewma: Optional[float] = None
        if warmup != "off":
            from .warmup import CompilePlane
            self.compile_plane = CompilePlane(self).start(
                background=warmup == "background")

    # -- tuning-table consults -------------------------------------------
    def _consult_paged_variant(self, spec_span: int) -> Optional[str]:
        """The ``paged_attn_variant`` winner for this cache geometry on
        this device, or None (the dtype's default kernel) when the table
        has none or the winner cannot run at this dtype.  Called before
        the compile plane exists: graphs capture the chosen kernel."""
        from ...telemetry.tunetable import get_tuneplane
        if self.compile_plane is not None:
            raise RuntimeError("the K3 variant must be chosen before any "
                               "graph is captured")
        dtype = self.cfg.dtype
        winner = get_tuneplane().consult(
            "SlotEngine", VARIANT_SPACE,
            paged_geometry_key(self.max_len, self.cfg.num_kv_heads,
                               self.cfg.d_head, dtype, spec_span),
            validate=lambda w: variant_ok(w.get("variant"), dtype),
            device=self.device)
        return None if winner is None else str(winner["variant"])

    def _consult_min_bucket(self) -> int:
        """``llm_bucket_grid`` winner for this ``max_len`` on this device
        → the tuned bucket-grid floor, or the default 8."""
        from ...telemetry.tunetable import geometry_key, get_tuneplane
        winner = get_tuneplane().consult(
            "SlotEngine", "llm_bucket_grid",
            geometry_key(max_len=self.max_len),
            validate=lambda w: (
                isinstance(w.get("min_bucket"), int)
                and not isinstance(w["min_bucket"], bool)
                and 1 <= w["min_bucket"] <= self.max_len
                and (w["min_bucket"] & (w["min_bucket"] - 1)) == 0),
            device=self.device)
        return int(winner["min_bucket"]) if winner is not None else 8

    # -- step profiling ----------------------------------------------------
    def _capture_step_cost(self, prof, tokens: np.ndarray,
                           lengths: np.ndarray) -> None:
        """Once per step shape: the eager step's counted cost, run on
        copies of the cache and of the generator so the engine's state
        does not move (outside any graph capture, and outside the
        profiled step's time)."""
        S = tokens.shape[1]
        key = (f"llm_{'decode' if S == 1 else 'verify'}_step_"
               f"{self.attention_backend}"
               + (f"_s{S}" if S > 1 else "")
               + (f"_{self.paged_variant}" if self.paged_variant else ""))
        if key in prof.costs:
            return
        with prof.excluded():
            packed = torch.as_tensor(self._pack_step(tokens, lengths),
                                     device=self.device)
            cache = [{n: t.clone() for n, t in c.items()}
                     for c in self.cache]
            gen = torch.Generator(device=self.device)
            gen.set_state(self._gen.get_state())

            @torch.no_grad()
            def run():
                out = step_program(self.model, cache, packed,
                                   self.attention_backend, self.paged_variant)
                if S == 1:
                    out = sample_logits(out, gen, self.temperature,
                                        self.top_k, self.top_p)
                return out.cpu()

            prof.capture_cost(key, run, items=float(self.active_count),
                              device=self.device)

    def _profiled(self, tokens: np.ndarray, lengths: np.ndarray, fn):
        """``fn()`` (a step ending in its one host copy) as one profiled
        step: all of it is ``compute``."""
        prof = self.step_profiler
        if prof is None:
            return fn()
        if prof.capture_xla:
            self._capture_step_cost(prof, tokens, lengths)
        prof.step_begin()
        try:
            out = fn()
            prof.mark("compute")
        finally:
            prof.step_end()
        return out

    # -- capacity ----------------------------------------------------------
    @property
    def active_count(self) -> int:
        return int(self.active.sum())

    @property
    def free_slot_count(self) -> int:
        return self.n_slots - self.active_count

    @property
    def spec_acceptance_rate(self) -> float:
        """Accepted / drafted tokens, cumulative."""
        return self.spec_accepted / max(1, self.spec_drafted)

    def min_remaining_tokens(self) -> Optional[int]:
        """Smallest remaining token budget across active slots — the
        soonest a slot can free up (the serving loop's SLO-projection
        numerator).  None when no slot is active."""
        if not self.active.any():
            return None
        return int((self._max_new - self._generated)[self.active].min())

    def tokens_per_step_estimate(self) -> float:
        """Committed tokens per slot per engine step, an EWMA over recent
        steps, >= 1.0 (a plain step commits one token per active slot):
        the serving loop divides its remaining-token floor by it."""
        return max(1.0, self._tps_ewma or 1.0)

    def _set_occupancy(self) -> None:
        self._m_occ.set(self.active_count / self.n_slots, engine=self.name)

    # -- compile plane -----------------------------------------------------
    def _program_region(self, key: str):
        """Wrap one eager serving program (a prefill bucket, the prefix
        copy): a program the plane never warmed counts as a stall.  A
        plane-less engine pays nothing."""
        plane = self.compile_plane
        return (contextlib.nullcontext() if plane is None
                else plane.step_region(key))

    def admission_ready(self, prompt_len: int) -> bool:
        """Would admitting a ``prompt_len``-token prompt run a program the
        plane has not warmed?  Always True without a plane and once the
        plane is warm."""
        plane = self.compile_plane
        return plane is None or plane.admission_ready(prompt_len)

    # -- the cache programs (the reference's jitted bodies) ---------------
    @torch.no_grad()
    def _prefill_slot(self, padded: np.ndarray, plen: int, slot: int,
                      start: int, cache=None) -> torch.Tensor:
        """Prefill ``plen`` real tokens (``padded`` to a bucket length)
        into row ``slot`` of ``cache`` (default: the engine's) from
        position ``start``, in place → the logits (V,) f32 of the prompt's
        true last token."""
        cache = self.cache if cache is None else cache
        pb = len(padded)
        dev = self.device
        tokens = torch.as_tensor(padded[None], device=dev)
        positions = (start + torch.arange(pb, dtype=torch.int32,
                                          device=dev))[None]
        row = [{"k": c["k"][slot:slot + 1], "v": c["v"][slot:slot + 1]}
               for c in cache]
        logits, _ = self.model(tokens, positions=positions, cache=row,
                               cache_index=start)
        return logits[0, plen - 1]

    @torch.no_grad()
    def _copy_prefix(self, src: int, dst: int, length: int,
                     cache=None) -> None:
        """Copy K/V positions ``[0, length)`` of slot ``src`` into slot
        ``dst`` of ``cache`` (default: the engine's) — the
        longest-common-prefix reuse transfer."""
        for c in (self.cache if cache is None else cache):
            c["k"][dst, :length] = c["k"][src, :length]
            c["v"][dst, :length] = c["v"][src, :length]

    @torch.no_grad()
    def _restore_span(self, rows, slot: int, cache=None) -> None:
        """Write host K/V rows (per-layer ``{"k", "v"}`` of shape ``(span,
        kv_heads, d_head)``) into positions ``[0, span)`` of row ``slot``
        of ``cache`` (default: the engine's): a plain copy, as the
        reference's ``_restore_span_jit``, without its bucket padding."""
        for c, r in zip(self.cache if cache is None else cache, rows):
            span = r["k"].shape[0]
            c["k"][slot, :span].copy_(r["k"])
            c["v"][slot, :span].copy_(r["v"])

    def _pack_step(self, tokens: np.ndarray,
                   lengths: np.ndarray) -> np.ndarray:
        """The host side of one decode/verify step's input (the layout of
        :func:`step_program`): tokens ``(n, S)``, write offsets
        ``lengths - 1`` and the active mask.  Raises before any launch if
        an active slot's writes would pass the cache's end (a CUDA scatter
        out of bounds would fault the device)."""
        n, S = tokens.shape
        if (lengths[self.active] - 1 + S > self.max_len).any():
            raise RuntimeError(f"a verify of width {S} would write past "
                               f"max_len={self.max_len}")
        packed = np.empty((n, S + 2), np.int32)
        packed[:, :S] = tokens
        packed[:, S] = lengths - 1
        packed[:, S + 1] = self.active
        return packed

    @torch.no_grad()
    def _run_step(self, tokens: np.ndarray,
                  lengths: np.ndarray) -> torch.Tensor:
        """:func:`step_program` over every slot: a replay of the plane's
        graph for this width when the engine has a plane, else eager."""
        packed = self._pack_step(tokens, lengths)
        if self.compile_plane is not None:
            return self.compile_plane.run_step(packed)
        return step_program(self.model, self.cache,
                            torch.as_tensor(packed, device=self.device),
                            self.attention_backend, self.paged_variant)

    def _decode_step(self, tokens: np.ndarray,
                     lengths: np.ndarray) -> np.ndarray:
        """One decode step for every slot: feed each slot's pending token
        at its own position, sample the next (eagerly, on the step's
        logits, with the engine's generator).  Inactive slots compute a
        throwaway row and write nothing (``slot_mask``)."""
        def run():
            logits = self._run_step(tokens[:, None], lengths)
            nxt = sample_logits(logits, self._gen, self.temperature,
                                self.top_k, self.top_p)
            return nxt.cpu().numpy()
        return self._profiled(tokens[:, None], lengths, run)

    def _verify_forward(self, tokens: np.ndarray,
                        lengths: np.ndarray) -> np.ndarray:
        """One speculative VERIFY forward: every slot's pending token plus
        its drafted span (``tokens`` is ``(n_slots, S)``) at positions
        ``lengths-1 ..``, → the model's greedy continuation at every
        position ``(n_slots, S)`` int32."""
        return self._profiled(
            tokens, lengths,
            lambda: self._run_step(tokens, lengths).cpu().numpy())

    # -- prefix reuse ------------------------------------------------------
    def _radix_for(self, tenant: str) -> RadixPrefixIndex:
        idx = self._radices.get(tenant)
        if idx is None:
            idx = self._radices[tenant] = RadixPrefixIndex()
        return idx

    def _register_prefix(self, slot: int, ids: np.ndarray) -> None:
        tenant = self._slot_tenant[slot]
        prev = self._slot_radix.get(slot)
        if prev is not None and prev != tenant:
            # the slot changed hands: its old owner's index must not keep
            # pointing at K/V the new owner is about to overwrite
            idx = self._radices.get(prev)
            if idx is not None:
                idx.remove(slot)
            del self._slot_radix[slot]
        if len(ids) < self.min_prefix:
            idx = self._radices.get(tenant)
            if idx is not None:
                idx.remove(slot)
            self._slot_radix.pop(slot, None)
        else:
            self._radix_for(tenant).insert(ids, slot)
            self._slot_radix[slot] = tenant

    def _clamp_reuse(self, lcp: int, total: int) -> int:
        """Shrink a reuse length until the remaining tail's PADDED
        prefill bucket fits inside ``max_len`` (``lcp == total``, a full
        restore with no tail, passes through)."""
        if lcp >= total:
            return min(lcp, total)
        while lcp >= self.min_prefix \
                and lcp + self._bucket(total - lcp) > self.max_len:
            lcp = self.max_len - self._bucket(total - lcp)
        return max(0, lcp)

    def _best_prefix(self, prompt: np.ndarray,
                     dst: int) -> Tuple[Optional[int], int]:
        """Longest common prefix between ``prompt`` and any slot of the
        admitting tenant's index (``dst`` itself wins ties: its K/V is
        already in place), capped at ``len(prompt) - 1`` and
        bucket-clamped; ``(None, 0)`` below ``min_prefix``."""
        radix = self._radices.get(self._slot_tenant[dst])
        if radix is None:
            return None, 0
        src, lcp = radix.longest_prefix(prompt, prefer=dst)
        if src is None:
            return None, 0
        lcp = int(min(lcp, self.kv_len[src], len(prompt) - 1))
        lcp = self._clamp_reuse(lcp, len(prompt))
        if lcp < self.min_prefix:
            return None, 0
        return src, lcp

    # -- admission ---------------------------------------------------------
    def _pick_slot(self) -> Optional[int]:
        free = np.flatnonzero(~self.active)
        if len(free) == 0:
            return None
        # least-recently-retired first: the freshest retired caches stay
        # resident longest, which is what multi-turn prefix reuse wants
        return int(free[np.argmin(self._retired_at[free])])

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _sample_one(self, logits: torch.Tensor) -> int:
        return int(sample_logits(logits[None], self._gen, self.temperature,
                                 self.top_k, self.top_p)[0])

    def admit(self, prompt_ids, max_new_tokens: int,
              tenant: str = "default") -> Optional[AdmitResult]:
        """Admit one sequence into a free slot (prefill + first token).
        Returns None when every slot is busy.  Raises ``ValueError`` for a
        prompt that cannot fit.  ``tenant`` scopes prefix reuse."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # room for prompt + every generated token incl. the final
        # sampled-but-never-fed one
        if len(prompt) + max_new + 1 > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)} tokens) + max_new_tokens "
                f"({max_new}) exceeds the engine's max_len "
                f"({self.max_len})")
        slot = self._pick_slot()
        if slot is None:
            return None
        t0 = time.perf_counter()
        tenant = str(tenant)
        # the slot's tenant is set BEFORE any cache lookup: _best_prefix
        # and _register_prefix scope themselves by it
        self._slot_tenant[slot] = tenant
        src, lcp = self._best_prefix(prompt, slot)
        restored = False
        if self.kv_arena is not None:
            # host tier: a spilled span longer than any device-resident
            # prefix restores instead (device reuse wins ties); every
            # failure degrades to the device or cold path below
            akey, alcp = self.kv_arena.longest_prefix(prompt, tenant=tenant)
            alcp = self._clamp_reuse(int(min(alcp, len(prompt) - 1)),
                                     len(prompt))
            if akey is not None and alcp >= self.min_prefix \
                    and alcp > lcp:
                restored = self._restore_from_arena(akey, alcp, slot,
                                                    tenant=tenant)
                if restored:
                    src, lcp = None, alcp
        if restored or (src is not None and lcp > 0):
            if not restored and src != slot:
                with self._program_region(PREFIX_COPY_KEY):
                    self._copy_prefix(src, slot, lcp)
            # src == slot: in-place resume, the K/V is already there
            self.prefix_hits += 1
            self.prefix_tokens_reused += lcp
            self._m_reuse.inc(1, engine=self.name)
            self._m_reuse_tok.inc(lcp, engine=self.name)
        else:
            lcp = 0
        tail = prompt[lcp:]
        pb = self._bucket(len(tail))
        padded = np.full(pb, self.pad_id, np.int32)
        padded[:len(tail)] = tail
        with self._program_region(_prefill_program_key(pb)):
            last = self._prefill_slot(padded, len(tail), slot, lcp)
        logits = last.cpu().numpy().astype(np.float32)
        tok = (int(np.argmax(logits)) if self.temperature <= 0.0
               else self._sample_one(last))
        plen = len(prompt)
        self.ctx[slot, :plen] = prompt
        self.ctx[slot, plen] = tok
        self.lengths[slot] = plen + 1
        self.kv_len[slot] = plen
        self.active[slot] = True
        self._max_new[slot] = max_new
        self._generated[slot] = 1
        self._register_prefix(slot, prompt)
        if self._drafter is not None:
            self._spec_k[slot] = self._spec_k0
            self._spec_ewma[slot] = 1.0
            self._drafter.begin(slot, self.ctx[slot], plen + 1)
        self.admissions += 1
        self._m_admit.inc(1, engine=self.name, tenant=tenant)
        self.tokens_generated += 1
        self._m_tokens.inc(1, engine=self.name)
        finished, reason = self._finish_reason(slot, tok)
        if finished:
            self._retire(slot, reason)
        self._set_occupancy()
        self._mkv.admit_latency.observe(
            time.perf_counter() - t0, engine=self.name,
            path="restore" if restored else "cold")
        return AdmitResult(slot, tok, finished, lcp, logits, bucket=pb,
                           reason=reason)

    # -- stepping ----------------------------------------------------------
    def _finish_reason(self, slot: int,
                       tok: int) -> Tuple[bool, Optional[str]]:
        if self.eos_id is not None and tok == self.eos_id:
            return True, "eos"
        if self._generated[slot] >= self._max_new[slot]:
            return True, "length"
        return False, None

    def _retire(self, slot: int, reason: str) -> None:
        self.active[slot] = False
        self._retired_at[slot] = time.monotonic()
        self.evictions += 1
        self._m_evict.inc(1, engine=self.name, reason=reason,
                          tenant=self._slot_tenant[slot])
        span = int(self.kv_len[slot])
        if reason != "reset" and span >= self.min_prefix:
            # re-index the slot under its FULL retired context (prompt +
            # generated tokens) so a follow-up turn matches through it
            self._register_prefix(slot, self.ctx[slot, :span])
            if self.kv_arena is not None:
                self._spill_slot(slot, span,
                                 "preempt" if reason == "preempted"
                                 else "retire")

    @torch.no_grad()
    def _spill_slot(self, slot: int, span: int, kind: str) -> None:
        """Spill the slot's live K/V span to the host arena: the layers'
        rows stacked on the device into one (L, 2, span, KH, DH) tensor,
        then one device-to-host copy.  Never breaks retirement: a failure
        is flight-recorded and the spill lost (the conversation
        cold-prefills later)."""
        t0 = time.perf_counter()
        try:
            rows = torch.stack([torch.stack([c["k"][slot, :span],
                                             c["v"][slot, :span]])
                                for c in self.cache]).cpu()
            self.kv_arena.put(self.ctx[slot, :span], rows, kind=kind,
                              tenant=self._slot_tenant[slot])
        except Exception as exc:  # noqa: BLE001: a spill is best-effort
            _flight_record("kvtier_spill_failed", engine=self.name,
                           slot=int(slot), error=repr(exc))
            return
        self.spill_count += 1
        self.spill_bytes += rows.numel() * rows.element_size()
        self.spill_seconds += time.perf_counter() - t0

    def _restore_from_arena(self, key: int, span: int, slot: int,
                            tenant: str = "default") -> bool:
        """Restore ``span`` K/V rows of arena entry ``key`` into ``slot``.
        False on any degraded outcome (a checksum failure, an entry
        evicted since the probe, another tenant's key): counted, and the
        caller cold-prefills."""
        try:
            rows = self.kv_arena.fetch(key, span, tenant=tenant)
        except ChecksumError:
            self._mkv.restores.inc(1, engine=self.name, source="host",
                                   outcome="corrupt")
            _flight_record("kvtier_restore_corrupt", engine=self.name,
                           key=int(key), tokens=int(span))
            return False
        except KeyError:
            self._mkv.restores.inc(1, engine=self.name, source="host",
                                   outcome="miss")
            return False
        with self._program_region(_restore_program_key(self._bucket(span))):
            self._restore_span(rows, slot)
        self.restore_count += 1
        self.restore_tokens += int(span)
        self._mkv.restores.inc(1, engine=self.name, source="host",
                               outcome="ok")
        return True

    # -- preemption --------------------------------------------------------
    def preempt_slot(self) -> Optional[int]:
        """The active slot with the most remaining token budget; None when
        idle."""
        if not self.active.any():
            return None
        rem = np.where(self.active, self._max_new - self._generated, -1)
        return int(np.argmax(rem))

    def preempt(self, slot: int) -> Optional[Dict[str, Any]]:
        """Evict an ACTIVE slot mid-decode: spill its K/V to the arena
        (when attached) and return a resume ticket (the full context
        including the pending token, the valid K/V span, the budget
        position and the tenant).  :meth:`resume` continues the sequence
        token-exactly."""
        if not self.active[slot]:
            return None
        ticket = {"ids": self.ctx[slot, :int(self.lengths[slot])].copy(),
                  "kv_len": int(self.kv_len[slot]),
                  "generated": int(self._generated[slot]),
                  "max_new": int(self._max_new[slot]),
                  "tenant": self._slot_tenant[slot]}
        self._retire(slot, "preempted")
        if self._drafter is not None:
            self._drafter.forget(slot)
        self._set_occupancy()
        return ticket

    def resume(self, ticket: Dict[str, Any]) -> Optional[int]:
        """Re-admit a preempted ticket into a free slot and continue
        decoding where it left off: the K/V span is restored from the host
        arena when possible, else copied from a device-resident prefix,
        and the rest cold-prefilled; all three reproduce the same K/V, so
        the continuation is token-exact.  Returns the slot, or None when
        every slot is busy."""
        ids = np.asarray(ticket["ids"], np.int32).reshape(-1)
        span = int(ticket["kv_len"])
        if len(ids) == 0 or span < 1 or span >= len(ids):
            # the pending token ids[span] must exist past the K/V span
            raise ValueError("malformed resume ticket")
        slot = self._pick_slot()
        if slot is None:
            return None
        tenant = str(ticket.get("tenant", "default"))
        self._slot_tenant[slot] = tenant
        est = 0
        if self.kv_arena is not None and span >= self.min_prefix:
            akey, alcp = self.kv_arena.longest_prefix(ids[:span],
                                                      tenant=tenant)
            alcp = self._clamp_reuse(int(min(alcp, span)), span)
            if akey is not None and alcp >= self.min_prefix \
                    and self._restore_from_arena(akey, alcp, slot,
                                                 tenant=tenant):
                est = alcp
        if est == 0:
            radix = self._radices.get(tenant)
            src, dlcp = (radix.longest_prefix(ids[:span], prefer=slot)
                         if radix is not None else (None, 0))
            if src is not None:
                dlcp = self._clamp_reuse(
                    int(min(dlcp, self.kv_len[src], span)), span)
                if dlcp >= self.min_prefix:
                    if src != slot:
                        with self._program_region(PREFIX_COPY_KEY):
                            self._copy_prefix(src, slot, dlcp)
                    est = dlcp
        if est < span:
            # cold tail: rebuild K/V for ids[est:span]; the logits are
            # discarded — the pending token ids[span] is already committed
            tail = ids[est:span]
            pb = self._bucket(len(tail))
            padded = np.full(pb, self.pad_id, np.int32)
            padded[:len(tail)] = tail
            with self._program_region(_prefill_program_key(pb)):
                self._prefill_slot(padded, len(tail), slot, est)
        ln = len(ids)
        self.ctx[slot, :ln] = ids
        self.lengths[slot] = ln
        self.kv_len[slot] = span
        self.active[slot] = True
        self._max_new[slot] = int(ticket["max_new"])
        self._generated[slot] = int(ticket["generated"])
        self._register_prefix(slot, ids[:span])
        if self._drafter is not None:
            self._spec_k[slot] = self._spec_k0
            self._spec_ewma[slot] = 1.0
            self._drafter.begin(slot, self.ctx[slot], ln)
        self._set_occupancy()
        return slot

    def cancel(self, slot: int) -> None:
        """Retire ``slot`` early; its K/V stays as prefix material."""
        if self.active[slot]:
            self._retire(slot, "cancelled")
            self._set_occupancy()

    def reset(self) -> None:
        """Clear every slot and zero the cache in place (after a failed
        step: active sequences are lost and no K/V is a valid prefix any
        more).  The cache keeps its storage, so the plane's graphs stay
        bound to it."""
        for slot in np.flatnonzero(self.active):
            self._retire(int(slot), "reset")
        for c in self.cache:
            c["k"].zero_()
            c["v"].zero_()
        self.kv_len[:] = 0
        self.lengths[:] = 0
        self._radices.clear()
        self._slot_radix.clear()
        if self._drafter is not None:
            for slot in range(self.n_slots):
                self._drafter.forget(slot)
            self._spec_k[:] = self._spec_k0
            self._spec_ewma[:] = 1.0
        self._m_occ.set(0.0, engine=self.name)

    def _decode_step_args(self) -> np.ndarray:
        """Per-slot live lengths for THIS step, inactive slots at 1: the
        spans the byte ledger prices (a verify adds its S-1 extra
        positions).  The reference also derived its static span bucket
        here; the CUDA kernel's loop bound is dynamic, so none is
        needed."""
        return np.where(self.active, self.lengths, 1)

    def _account_decode_bytes(self, spans: np.ndarray, served: int) -> None:
        """Add one step's decode-attention K/V bytes in the reference's
        ledger (the paged read over ``spans``, every slot included, or the
        full-capacity dense read) to :attr:`decode_attn_bytes` and, per
        token ``served``, to the ``llm_decode_bytes_per_token`` gauge; the
        exact live-span bytes go to :attr:`decode_attn_live_bytes`."""
        cfg = self.cfg
        itemsize = _itemsize(cfg.dtype)
        if self._paged_geo is not None:
            nbytes = paged_read_bytes(
                spans, self._paged_geo.tile, cfg.num_kv_heads, cfg.d_head,
                itemsize, cfg.num_layers)
            keys = int(np.clip(np.asarray(spans, np.int64), 1,
                               self.max_len).sum())
            live = (cfg.num_layers * 2 * keys * cfg.num_kv_heads
                    * cfg.d_head * itemsize)
        else:
            nbytes = live = dense_read_bytes(
                self.n_slots, self.max_len, cfg.num_kv_heads, cfg.d_head,
                itemsize, cfg.num_layers)
        self.decode_attn_bytes += nbytes
        self.decode_attn_live_bytes += live
        self._m_decode_bytes.set(nbytes / max(1, served), engine=self.name,
                                 backend=self.attention_backend)

    def step(self) -> List[StepEvent]:
        """One decode step across every active slot → the per-slot events
        (several per slot when a drafted span is accepted); empty when no
        slot is active.  With ``spec_draft_len > 0`` any draft hit makes
        the step a multi-token verify; an all-miss step is the plain
        one-token step."""
        if not self.active.any():
            return []
        if self._drafter is not None:
            s_cap = self._spec_headroom()
            drafts = self._collect_drafts(s_cap)
            if drafts:
                return self._finish_step(self._verify_step(drafts, s_cap))
        return self._finish_step(self._plain_step())

    def _finish_step(self, events: List[StepEvent]) -> List[StepEvent]:
        """Retirement, counters and the per-slot tokens-per-step EWMA."""
        for ev in events:
            if ev.finished:
                self._retire(ev.slot, ev.reason)
        self.steps_run += 1
        tps = len(events) / max(1, len({ev.slot for ev in events}))
        self._tps_ewma = (tps if self._tps_ewma is None
                          else 0.8 * self._tps_ewma + 0.2 * tps)
        self._m_tokens.inc(len(events), engine=self.name)
        self._set_occupancy()
        return events

    def _plain_step(self) -> List[StepEvent]:
        """The one-token step."""
        idx = np.arange(self.n_slots)
        lengths = self._decode_step_args()
        tokens = np.where(self.active,
                          self.ctx[idx, np.maximum(self.lengths - 1, 0)],
                          self.pad_id).astype(np.int32)
        nxt = self._decode_step(tokens, lengths)
        self._account_decode_bytes(lengths, int(self.active.sum()))
        events: List[StepEvent] = []
        for slot in np.flatnonzero(self.active):
            slot = int(slot)
            tok = int(nxt[slot])
            ln = int(self.lengths[slot])
            self.ctx[slot, ln] = tok
            self.lengths[slot] = ln + 1
            self.kv_len[slot] = ln        # the fed token's K/V just landed
            self._generated[slot] += 1
            self.tokens_generated += 1
            if self._drafter is not None:
                self._drafter.extend(slot, self.ctx[slot], ln, ln + 1)
            if self.trace_sink is not None:
                self.trace_sink(slot, "decode", tokens=1)
            finished, reason = self._finish_reason(slot, tok)
            events.append(StepEvent(slot, tok, finished, reason))
        return events

    # -- speculative decoding ----------------------------------------------
    def _spec_headroom(self) -> int:
        """Cache headroom for this step's verify width: S cannot exceed
        ``max_len - longest_active_length + 1`` (>= 2 always)."""
        return self.max_len - int(self.lengths[self.active].max()) + 1

    def _collect_drafts(self, s_cap: int) -> Dict[int, np.ndarray]:
        """A draft per active slot, capped by its remaining budget, its
        adaptive cap and the step's headroom ``s_cap``."""
        out: Dict[int, np.ndarray] = {}
        hits = misses = 0
        for slot in np.flatnonzero(self.active):
            slot = int(slot)
            rem = int(self._max_new[slot] - self._generated[slot])
            k_cap = min(self.spec_draft_len, int(self._spec_k[slot]),
                        rem - 1, s_cap - 1)
            if k_cap < 1:
                continue            # no draft possible: not a miss
            d = self._drafter.draft(slot, self.ctx[slot],
                                    int(self.lengths[slot]), k_cap)
            if len(d):
                out[slot] = d
                hits += 1
            else:
                misses += 1
        self.spec_draft_hits += hits
        self.spec_draft_misses += misses
        if hits:
            self._m_spec_hit.inc(hits, engine=self.name)
        if misses:
            self._m_spec_miss.inc(misses, engine=self.name)
        return out

    def _spec_bucket(self, max_k: int, s_cap: int) -> int:
        """S for this verify step: the next power of two covering pending
        + longest draft, shrunk to the cache headroom."""
        s = max(2, _next_pow2(1 + max_k))
        while s > s_cap and s > 2:
            s //= 2
        return s

    def _verify_step(self, drafts: Dict[int, np.ndarray],
                     s_cap: int) -> List[StepEvent]:
        """One multi-token verify step: score every slot's draft span in
        ONE forward, accept the longest exact-greedy prefix and commit
        accepted + 1 tokens (only committed positions become attendable
        through ``lengths``/``kv_len``)."""
        idx = np.arange(self.n_slots)
        S = self._spec_bucket(max(len(d) for d in drafts.values()), s_cap)
        lengths = self._decode_step_args()
        tokens = np.full((self.n_slots, S), self.pad_id, np.int32)
        tokens[:, 0] = np.where(
            self.active, self.ctx[idx, np.maximum(self.lengths - 1, 0)],
            self.pad_id)
        klen = np.zeros(self.n_slots, np.int64)
        for slot, d in drafts.items():
            d = d[:S - 1]
            tokens[slot, 1:1 + len(d)] = d
            klen[slot] = len(d)
        g = self._verify_forward(tokens, lengths)
        self.spec_steps += 1
        served = 0
        events: List[StepEvent] = []
        for slot in np.flatnonzero(self.active):
            slot = int(slot)
            ln = int(self.lengths[slot])
            k_s = int(klen[slot])
            row = g[slot]
            # longest exact-greedy prefix of the draft, then the model's
            # bonus token after it
            a = 0
            while a < k_s and int(tokens[slot, a + 1]) == int(row[a]):
                a += 1
            commit = row[:a + 1]
            rem = int(self._max_new[slot] - self._generated[slot])
            commit = commit[:rem]
            if self.eos_id is not None:
                eos = np.flatnonzero(commit == self.eos_id)
                if len(eos):
                    commit = commit[:int(eos[0]) + 1]
            c = len(commit)
            self.ctx[slot, ln:ln + c] = commit
            self.lengths[slot] = ln + c
            # positions ln-1 .. ln+c-2 were fed the COMMITTED tokens;
            # rejected positions beyond hold junk the next step
            # overwrites before any query can attend it
            self.kv_len[slot] = ln + c - 1
            self._generated[slot] += c
            self.tokens_generated += c
            served += c
            if k_s:
                self.spec_drafted += k_s
                self.spec_accepted += min(a, k_s)
                self._m_spec_span.observe(c, engine=self.name)
                if self.spec_adapt:
                    self._adapt_slot(slot, min(a, k_s) / k_s)
            if self._drafter is not None:
                self._drafter.extend(slot, self.ctx[slot], ln, ln + c)
            if self.trace_sink is not None:
                self.trace_sink(slot, "verify", tokens=c, drafted=k_s,
                                accepted=min(a, k_s) if k_s else 0)
            finished, reason = self._finish_reason(slot, int(commit[-1]))
            for j, tok in enumerate(commit):
                last = j == c - 1
                events.append(StepEvent(slot, int(tok),
                                        finished and last,
                                        reason if last else None))
        self._account_decode_bytes(lengths + (S - 1), served)
        return events

    def _adapt_slot(self, slot: int, acceptance: float) -> None:
        """Fold one verify outcome into the slot's acceptance EWMA and
        AIMD its draft cap: a fully-accepted draft doubles it, one that
        lost more than half halves it, and an EWMA under 0.2 collapses it
        to the 1-token probe."""
        w = 0.3
        e = (1 - w) * self._spec_ewma[slot] + w * acceptance
        self._spec_ewma[slot] = e
        k = int(self._spec_k[slot])
        if e < 0.2:
            self._spec_k[slot] = 1
        elif acceptance >= 1.0:
            self._spec_k[slot] = min(self.spec_draft_len, max(2, 2 * k))
        elif acceptance < 0.5:
            self._spec_k[slot] = max(1, k // 2)

    # -- output ------------------------------------------------------------
    def generated_ids(self, slot: int) -> np.ndarray:
        """The tokens generated so far in ``slot`` (prompt excluded)."""
        start = int(self.lengths[slot] - self._generated[slot])
        return self.ctx[slot, start:int(self.lengths[slot])].copy()

    def run_to_completion(self, max_steps: Optional[int] = None
                          ) -> Dict[int, np.ndarray]:
        """Drive :meth:`step` until every slot retires → {slot: generated
        ids}."""
        slots = [int(s) for s in np.flatnonzero(self.active)]
        steps = 0
        while self.active.any():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return {s: self.generated_ids(s) for s in slots}
