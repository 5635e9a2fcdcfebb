"""Continuous-batching LLM serving: one listener + slotted decode loop.

The PyTorch port of the JAX package's ``serving/llm.py``.
:class:`LLMServer` wires a :class:`~.server.ServingServer` to the port's
:class:`~synapseml_tpu_torch.models.llm.SlotEngine` through the
:class:`~.server._DecodeLoop` scheduler, so requests are admitted into
KV-cache slots *every decode step* instead of waiting for a full batch.

Request body (JSON, POST to the api path)::

    {"ids": [1, 2, 3], "max_new_tokens": 32}          # raw token ids
    {"prompt": "text", "stream": true}                 # with a tokenizer
    {"ids": [...], "session": "conv"}                  # journaled turn
    {"session": "conv", "resume": true}                # failover resume

Replies carry ``{"ids": [...]}`` (plus ``"completion"`` when a
tokenizer is configured); ``stream: true`` switches to a chunked body
with one ``{"token": id}`` JSON line per generated token and a final
``{"done": true, ...}`` line.  Load shedding, ``Retry-After``, drain
semantics, and ``/metrics``/``/healthz``/``/readyz``/``/tracez``/
``/sloz`` are the reference's serving contract.

The session survivability plane: ``kv_arena`` / ``kv_arena_bytes``
attach a host KV arena to the engine (retired slots spill, warm
conversations restore instead of prefilling), and ``journal`` /
``journal_dir`` arm the fsync'd per-session journal, so a killed
replica's conversation resumes token-exactly here through a
``{"session", "resume"}`` request.  Disaggregated prefill:
``prefill_pool`` (a :class:`~.disagg.PrefillPool`) takes each fresh
prompt's prefill off this replica and ships its K/V into this replica's
host arena, so the admit restores it instead of prefilling.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .server import ServingRequest, ServingServer, _DecodeLoop


class LLMServer:
    """Serve an LLM with continuous batching over a slotted KV cache.

    ``model`` (a :class:`~synapseml_tpu_torch.models.llm.LlamaModel`,
    which holds its parameters) builds a
    :class:`~synapseml_tpu_torch.models.llm.SlotEngine` on ``device``
    (default ``"cuda"``, which raises without a card unless
    ``device="cpu"``); or pass a prebuilt ``engine=`` on that device.
    ``tokenizer`` (optional, ``encode``/``decode``) lets requests carry
    ``"prompt"`` text instead of raw ``"ids"``.  ``ttft_slo_s`` arms
    SLO-aware admission control: queued requests whose projected
    time-to-first-token exceeds it answer 503 + ``Retry-After`` — and it
    doubles as the windowed SLO plane's TTFT objective (``GET /sloz``;
    ``token_slo_s`` optionally declares a per-token one).  Every request
    is traced at admission (sampling via ``trace_sample_every``;
    ``GET /tracez``) and the propagated ``X-SML-Trace-Id`` header keeps
    cross-replica hops attributable.  ``attention_backend`` selects the
    decode-step attention read (``'auto'`` = the paged K3 kernel when the
    geometry fits).  ``spec_draft_len`` turns on speculative decoding
    (greedy only).  ``warmup`` (``'background'``/``'sync'``; default
    ``'off'``) arms the compile plane: ``'background'`` returns at once
    and ``/readyz`` answers 503 ``"warming"`` until the plane's thread
    has built the kernels and captured every step graph; the decode loop
    holds queued requests until then.  ``kv_arena_bytes`` builds a
    :class:`~synapseml_tpu_torch.models.llm.kvtier.HostKVArena` of that
    budget for the engine (or pass ``kv_arena``), and ``journal_dir`` a
    :class:`~synapseml_tpu_torch.models.llm.kvtier.SessionJournal` under
    that directory (or pass ``journal``).  ``prefill_pool`` (a
    :class:`~.disagg.PrefillPool`) offers every fresh prompt to the pool
    before admission; its K/V lands in this replica's arena (so pass
    ``kv_arena``/``kv_arena_bytes`` too) and every handoff failure
    degrades to a local prefill on this engine's device, counted in
    ``disagg_handoffs_total``.  The pool is bound to ``api_path``, so
    ``/sloz`` grows the ``@phase=prefill|decode`` planes the per-phase
    autoscalers read."""

    def __init__(self, model: Any = None, *, engine: Any = None,
                 tokenizer: Any = None, n_slots: int = 16, max_len: Optional[int] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 api_path: str = "/generate",
                 max_new_tokens_default: int = 32,
                 ttft_slo_s: Optional[float] = None,
                 token_slo_s: Optional[float] = None,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, min_prefix: int = 8,
                 max_queue: int = 1024, reply_timeout_s: float = 30.0,
                 attention_backend: str = "auto",
                 spec_draft_len: int = 0, spec_ngram: int = 3,
                 trace_sample_every: Optional[int] = None,
                 warmup: str = "off",
                 kv_arena: Any = None,
                 kv_arena_bytes: Optional[int] = None,
                 journal: Any = None,
                 journal_dir: Optional[str] = None,
                 qos: Any = None,
                 tenant_policies: Optional[Dict[str, Any]] = None,
                 max_tenants: int = 256,
                 prefill_pool: Any = None,
                 engine_kwargs: Optional[Dict[str, Any]] = None,
                 device: Any = "cuda"):
        from ..device import resolve_device
        dev = resolve_device(device)
        if kv_arena is None and kv_arena_bytes:
            from ..models.llm.kvtier import HostKVArena
            kv_arena = HostKVArena(int(kv_arena_bytes),
                                   name=api_path.strip("/") or "llm")
        if journal is None and journal_dir:
            from ..models.llm.kvtier import SessionJournal
            journal = SessionJournal(journal_dir,
                                     name=api_path.strip("/") or "llm")
        if engine is None:
            from ..models.llm import SlotEngine
            engine = SlotEngine(model, n_slots=n_slots, max_len=max_len,
                                temperature=temperature, top_k=top_k,
                                top_p=top_p, eos_id=eos_id, pad_id=pad_id,
                                min_prefix=min_prefix,
                                attention_backend=attention_backend,
                                spec_draft_len=spec_draft_len,
                                spec_ngram=spec_ngram, warmup=warmup,
                                kv_arena=kv_arena, device=dev,
                                **(engine_kwargs or {}))
        elif engine.device != dev:
            raise ValueError(f"the engine is on {engine.device} but "
                             f"device={str(device)!r}")
        self.engine = engine
        self.kv_arena = getattr(engine, "kv_arena", kv_arena)
        self.journal = journal
        self.tokenizer = tokenizer
        self.server = ServingServer(host, port, api_path,
                                    reply_timeout_s=reply_timeout_s,
                                    max_queue=max_queue)
        # compile-plane readiness gate: with a warming engine /readyz
        # answers 503 "warming" (with the plane's snapshot, host values
        # only) until every program is warm, so a balancer never routes
        # traffic here early; direct requests queue and the decode loop
        # holds them until the plane is warm
        plane = getattr(engine, "compile_plane", None)
        if plane is not None:
            self.server.health.set_warmup(plane.snapshot)
        # multi-tenant QoS: a prebuilt QosScheduler via qos=, or just
        # per-tenant TenantPolicy contracts via tenant_policies= —
        # requests carry their tenant in the X-SML-Tenant header or the
        # "tenant" payload field; max_tenants bounds the dynamic
        # (unregistered) tenant ids that may materialise planes
        if qos is None and tenant_policies is not None:
            from .qos import QosScheduler
            qos = QosScheduler(policies=dict(tenant_policies))
        self.qos = qos
        self.prefill_pool = prefill_pool
        if prefill_pool is not None:
            prefill_pool.bind(api_path, self.kv_arena,
                              ttft_slo_s=ttft_slo_s)
        self._loop = _DecodeLoop(
            self.server, self.server._default, engine,
            input_parser=self._parse,
            output_formatter=self._format,
            max_new_tokens_default=max_new_tokens_default,
            ttft_slo_s=ttft_slo_s, token_slo_s=token_slo_s,
            trace_sample_every=trace_sample_every,
            journal=journal, qos=qos, max_tenants=max_tenants,
            disagg=prefill_pool)
        # the loop constructs a default scheduler when none was given —
        # surface THAT one so callers can set policies/read attribution
        if self.qos is None:
            self.qos = self._loop.qos

    # -- request/reply shaping --------------------------------------------
    def _parse(self, req: ServingRequest) -> Dict[str, Any]:
        body = req.json()
        if "ids" in body:
            spec = dict(body)
        elif body.get("resume") and body.get("session") is not None \
                and self.journal is not None:
            # failover resume: the prompt + committed tokens come from the
            # session journal's replay, not the request body
            spec = dict(body)
        elif "prompt" in body and self.tokenizer is not None:
            # budget prompt tokens against the engine window, leaving
            # room for the continuation (LLMTransformer's contract)
            budget = self.engine.max_len - int(
                body.get("max_new_tokens",
                         self._loop.max_new_tokens_default)) - 1
            rows = self.tokenizer.encode([str(body["prompt"])],
                                         max(budget, 1))[0]
            ids = [int(t) for t in rows[0] if t]
            spec = dict(body, ids=ids or [0])
        else:
            raise ValueError('request needs "ids" (or "prompt" with a '
                             "tokenizer configured)")
        return spec

    def _format(self, ids: List[int]) -> Dict[str, Any]:
        out: Dict[str, Any] = {"ids": [int(t) for t in ids]}
        if self.tokenizer is not None:
            out["completion"] = self.tokenizer.decode([ids])[0]
        return out

    # -- server surface ----------------------------------------------------
    @property
    def url(self) -> str:
        return self.server.url

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful shutdown with the serving zero-drop contract:
        the listener sheds NEW work immediately, the decode loop keeps
        running so every in-flight sequence decodes to completion (or
        answers a clean 503 + ``Retry-After`` when its projected TTFT is
        already past the SLO), and only then does the loop stop."""
        drained = self.server.drain(timeout_s)
        self._loop.stop()
        return drained

    def close(self) -> None:
        self._loop.stop()
        self.server.close()
