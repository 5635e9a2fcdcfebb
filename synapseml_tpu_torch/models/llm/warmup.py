"""Warm-up of the serving program lattice — the compile plane.

The PyTorch port of the JAX package's ``models/llm/warmup.py``.  Every
program a :class:`~synapseml_tpu_torch.models.llm.slots.SlotEngine` can
run follows from its static config: the decode step, one verify step per
power-of-two query width when speculative decoding is armed, the prefix
copy and one prefill per prompt bucket.  The reference compiles that
lattice before admission so that no XLA compile stalls the decode loop.

Eager PyTorch compiles nothing.  What stalls a first step instead is
building and loading the kernels (``nvcc`` for K3) and PyTorch's lazy
module loading and cuBLAS choices; what costs every step is launching
the forward's ~1,100 kernels from Python.  So warming the lattice means:

- build and load the kernels (the ``build`` row, on the card only);
- capture each decode and verify program once as a
  ``torch.cuda.CUDAGraph`` over static buffers (:class:`StepGraph`), and
  replay it on every step;
- run each prefill bucket, the prefix copy and, for an engine with a
  host KV arena, each bucket's restore copy once, eagerly, on a 2-row
  scratch cache.  They run once per admission and take host ints, so
  they are not captured.

A graph is captured against the engine's live cache: its two eager
warm-up iterations run with every slot inactive, and the ``slot_mask``
gate then rewrites each row with the values it holds, so the cache stays
bitwise unchanged.  The graphs share one memory pool, the widest
captured first.  On the CPU the same static-buffer dispatch runs eagerly.

:class:`CompilePlane` keeps plain counters: ``programs_warm``,
``replays`` and ``stalls`` (a program that first ran inside the serving
loop).  ``start(background=True)`` warms the lattice on the plane's own
thread (the ``/readyz`` gate of ``serving.LLMServer`` answers 503
"warming" until it is done).  Until the plane is warm,
:meth:`CompilePlane.admission_ready` is False for every prompt, so a
serving loop touches the device only after the last capture: nothing
else launches work while a graph captures.  Every capture uses
``capture_error_mode="thread_local"``, so CUDA calls that other threads
make meanwhile (allocations, a listener's work, another engine's steps)
do not invalidate it, and the captures of all the process's planes take
turns under one lock (``_CAPTURE_LOCK``); :meth:`CompilePlane.snapshot`
reads no device state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ...kernels import launches
from .model import init_cache
from .slots import (PREFIX_COPY_KEY, _next_pow2, _prefill_program_key,
                    _restore_program_key, step_program)

__all__ = ["CompilePlane", "EXEMPT_METHODS", "PROGRAM_METHODS",
           "ProgramSpec", "StepGraph", "program_lattice"]

#: held for the whole of every graph capture in the process: two planes
#: warming at once (two servers starting together) capture in turn, and
#: the cyclic collector, which is process-wide, comes back on only once
#: the capture that turned it off has ended
_CAPTURE_LOCK = threading.Lock()

#: the engine methods that run a program of the lattice, by the kinds
#: they run (the entry-point sweep's contract: a new method that runs the
#: model or touches the cache fails the sweep until it is listed here or
#: in :data:`EXEMPT_METHODS`)
PROGRAM_METHODS = {
    "_run_step": ("decode", "verify"),
    "_prefill_slot": ("prefill",),
    "_copy_prefix": ("prefix_copy",),
    "_restore_span": ("restore",),
}
#: methods that touch the cache outside the serving loop's programs
EXEMPT_METHODS = {
    "__init__": "allocates the cache",
    "reset": "zeroes the cache in place between serving runs; the graphs "
             "stay bound to its storage",
    "_spill_slot": "reads a retired slot's span back to the host arena "
                   "(a device-side stack and one copy, no model program)",
    "_capture_step_cost": "the step profiler's cost capture: the eager "
                          "step, once per step shape, on a copy of the "
                          "cache and outside any graph",
}


def _step_program_key(backend: str, S: int) -> str:
    """Stable label of the decode (``S == 1``) or verify program of query
    width ``S``.  The reference's span buckets are gone: K3 reads each
    slot's span on the device."""
    return f"decode_{backend}" if S == 1 else f"verify_{backend}_s{S}"


@dataclasses.dataclass
class ProgramSpec:
    """One row of the program lattice: a stable key (the engine's
    dispatch label), its kind, the query width of a decode (1) or verify
    (> 1) step (0 for the other kinds), and a closure that warms it,
    given the plane."""
    key: str
    kind: str     # build | decode | verify | prefix_copy | prefill | restore
    run: Callable[["CompilePlane"], Any]
    S: int = 0


def program_lattice(engine) -> List[ProgramSpec]:
    """The engine's program lattice from its static config, in the
    reference's order: the kernel build (on the card, when the engine
    launches K3), the decode step, the prefix copy, the verify steps at S
    = 2, 4, ... up to ``_next_pow2(1 + spec_draft_len)``, then the
    prefill buckets ascending, then, for an engine with a host KV arena,
    one restore copy per bucket.  The reference's span buckets have no
    counterpart: K3 reads each slot's span on the device."""
    backend = engine.attention_backend
    specs: List[ProgramSpec] = []
    if engine.device.type == "cuda" and backend == "paged":
        def build(plane):
            from .paged_attn import _kernels
            _kernels()
        specs.append(ProgramSpec("build_paged_attn", "build", build))

    def step(S):
        return ProgramSpec(_step_program_key(backend, S),
                           "decode" if S == 1 else "verify",
                           lambda plane: plane._capture(S), S)
    specs.append(step(1))
    specs.append(ProgramSpec(
        PREFIX_COPY_KEY, "prefix_copy",
        lambda plane: engine._copy_prefix(0, 1, 1, cache=plane._scratch())))
    if engine.spec_draft_len:
        s = 2
        while s <= max(2, _next_pow2(1 + engine.spec_draft_len)):
            specs.append(step(s))
            s *= 2
    for pb in engine._buckets:
        def prefill(plane, pb=pb):
            padded = np.full(pb, engine.pad_id, np.int32)
            engine._prefill_slot(padded, 1, 0, 0, cache=plane._scratch())
        specs.append(ProgramSpec(_prefill_program_key(pb), "prefill",
                                 prefill))
    if getattr(engine, "kv_arena", None) is not None:
        cfg = engine.cfg
        for pb in engine._buckets:
            def restore(plane, pb=pb):
                row = torch.zeros((pb, cfg.num_kv_heads, cfg.d_head),
                                  dtype=cfg.dtype)
                engine._restore_span([{"k": row, "v": row}] * cfg.num_layers,
                                     0, cache=plane._scratch())
            specs.append(ProgramSpec(_restore_program_key(pb), "restore",
                                     restore))
    return specs


class StepGraph:
    """One decode (``S == 1``) or verify (``S > 1``) program of an engine
    over static buffers: the int32 input ``(n_slots, S + 2)`` of
    :func:`~.slots.step_program` (tokens, write offset, active flag),
    filled each step by one copy from a pinned staging buffer, and the
    program's output (decode logits, or the verify argmax).

    On the card the program is a CUDA graph, captured at construction
    into ``pool``; the K3 launches counted while it captured are added
    to the launch registry at each replay.  On the CPU the same buffers
    feed an eager run."""

    def __init__(self, engine, S: int, pool=None):
        self.engine = engine
        self.S = S
        dev = engine.device
        shape = (engine.n_slots, S + 2)
        self.inputs = torch.zeros(shape, dtype=torch.int32, device=dev)
        self._staging = torch.zeros(shape, dtype=torch.int32,
                                    pin_memory=dev.type == "cuda")
        self._host = self._staging.numpy()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.counts: Dict[str, int] = {}
        self.out: Optional[torch.Tensor] = None
        if dev.type == "cuda":
            self._capture(pool)

    def _program(self) -> torch.Tensor:
        eng = self.engine
        return step_program(eng.model, eng.cache, self.inputs,
                            eng.attention_backend, eng.paged_variant)

    @torch.no_grad()
    def _capture(self, pool) -> None:
        # the inputs are all zero: every slot is inactive, so the
        # warm-up iterations leave the live cache bitwise unchanged
        dev = self.engine.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._program()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # no cyclic collection while the stream captures: a collection
        # run by this thread could free an unreachable engine's graphs or
        # pinned buffers, whose destructors may not run during a capture
        # (torch.cuda.graph collects once before it begins)
        with _CAPTURE_LOCK:
            gc_enabled = gc.isenabled()
            gc.disable()
            try:
                with launches.recording() as counts, \
                        torch.cuda.graph(graph, pool=pool,
                                         capture_error_mode="thread_local"):
                    self.out = self._program()
            finally:
                if gc_enabled:
                    gc.enable()
        self.graph, self.counts = graph, counts

    @torch.no_grad()
    def replay(self, packed: np.ndarray) -> torch.Tensor:
        """Run the program on ``packed`` (the host input, see
        :meth:`SlotEngine._pack_step`) → its static output, valid until
        the next replay.  The caller's copy of the output to the host
        orders the next step's staging write after this step's copy."""
        self._host[...] = packed
        self.inputs.copy_(self._staging, non_blocking=True)
        if self.graph is None:
            self.out = self._program()
        else:
            self.graph.replay()
            launches.add(self.counts)
        return self.out


class CompilePlane:
    """The engine's compile plane: lattice warm-up and the step dispatch
    through captured graphs.

    States: ``cold`` (created) → ``warming`` (lattice running) → ``warm``
    (every program warm; ``warmup_seconds`` and ``ready_at`` set), or
    ``failed`` when a program raised — a synchronous :meth:`start` then
    re-raises, and the engine's constructor with it; a background one
    keeps the error in ``error`` (:meth:`wait` raises it), and its engine
    admits nothing: there is no silent eager path."""

    def __init__(self, engine):
        self.engine = engine
        self.status = "cold"
        self.warmup_seconds: Optional[float] = None
        #: ``time.monotonic()`` when the plane turned warm
        self.ready_at: Optional[float] = None
        #: the exception a background warm-up failed with
        self.error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        #: the pool's bytes as of the last capture (the snapshot reads no
        #: device state)
        self._pool_bytes = 0
        #: step dispatches through the plane's graphs (eager runs of the
        #: same buffers on the CPU)
        self.replays = 0
        #: programs that first ran inside the serving loop
        self.stalls = 0
        self._specs: List[ProgramSpec] = []
        self._warmed: set = set()
        self._graphs: Dict[int, StepGraph] = {}
        self._pool = (torch.cuda.graph_pool_handle()
                      if engine.device.type == "cuda" else None)
        self._scratch_cache = None

    # -- state -------------------------------------------------------------
    @property
    def is_warm(self) -> bool:
        return self.status == "warm"

    @property
    def programs_warm(self) -> int:
        return len(self._warmed)

    def pool_bytes(self) -> int:
        """Device bytes the allocator holds in the graphs' shared memory
        pool (0 on the CPU)."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def snapshot(self) -> Dict[str, Any]:
        """State, progress, timings and counters (host values only: the
        ``/readyz`` and ``/metrics`` handlers call it from the listener's
        thread, never touching the device)."""
        out = {"state": self.status, "programs_warm": self.programs_warm,
               "programs_total": len({s.key for s in self._specs}
                                     | self._warmed),
               "replays": self.replays, "stalls": self.stalls,
               "pool_bytes": self._pool_bytes}
        if self.warmup_seconds is not None:
            out["warmup_seconds"] = self.warmup_seconds
        if self.error is not None:
            out["error"] = repr(self.error)
        return out

    # -- warm-up -----------------------------------------------------------
    def start(self, background: bool = False) -> "CompilePlane":
        """Warm the whole lattice: the kernel build first, then the step
        graphs widest first (the narrower captures reuse the pool memory
        the wider one released), then the prefix copy and the prefill
        buckets — inline, or on the plane's own thread with
        ``background=True`` (:meth:`wait` joins it)."""
        if self.status != "cold":
            return self
        self.status = "warming"
        self._specs = program_lattice(self.engine)
        if not background:
            self._warm()
            return self
        self._thread = threading.Thread(
            target=self._warm_in_background, daemon=True,
            name=f"compile-plane-{getattr(self.engine, 'name', 'llm')}")
        self._thread.start()
        return self

    def _warm_in_background(self) -> None:
        try:
            dev = self.engine.device
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                self._warm()
        except BaseException as e:      # kept for wait() and the snapshot
            self.error = e

    def _warm(self) -> None:
        t0 = time.perf_counter()
        try:
            for spec in sorted(self._specs,
                               key=lambda s: (s.kind != "build", -s.S)):
                spec.run(self)
                self._warmed.add(spec.key)
            if self.engine.device.type == "cuda":
                torch.cuda.synchronize(self.engine.device)
            self._pool_bytes = self.pool_bytes()
        except BaseException:
            self.status = "failed"
            raise
        finally:
            self._scratch_cache = None
        self.warmup_seconds = time.perf_counter() - t0
        self.ready_at = time.monotonic()
        self.status = "warm"

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Join a background warm-up; True once warm.  Raises the error a
        failed warm-up raised."""
        if self._thread is not None:
            self._thread.join(timeout)
        if self.error is not None:
            raise RuntimeError(f"compile-plane warm-up failed: "
                               f"{self.error!r}") from self.error
        return self.is_warm

    def _scratch(self):
        """The 2-row cache the eager programs warm on."""
        if self._scratch_cache is None:
            eng = self.engine
            self._scratch_cache = init_cache(eng.cfg, 2, eng.max_len,
                                             eng.device)
        return self._scratch_cache

    def _capture(self, S: int) -> StepGraph:
        graph = self._graphs[S] = StepGraph(self.engine, S, self._pool)
        return graph

    # -- serving -----------------------------------------------------------
    def run_step(self, packed: np.ndarray) -> torch.Tensor:
        """Dispatch one decode/verify step (``packed``: the host input of
        width S + 2) through the graph of its width.  A width the warm-up
        did not capture is captured here, inside the serving loop, and
        counts as a stall."""
        S = packed.shape[1] - 2
        graph = self._graphs.get(S)
        if graph is None:
            graph = self._capture(S)
            self._warmed.add(_step_program_key(
                self.engine.attention_backend, S))
            self.stalls += 1
            self._pool_bytes = self.pool_bytes()
        self.replays += 1
        return graph.replay(packed)

    def admission_ready(self, prompt_len: int) -> bool:
        """Can a ``prompt_len``-token prompt admit?  Only once the whole
        lattice is warm: a partly warm plane may still be capturing on its
        own thread, and an admission's launches would land inside that
        capture."""
        return self.is_warm

    @contextlib.contextmanager
    def step_region(self, key: str):
        """Wrap one eager serving program: if ``key`` was never warmed,
        this run is its first, inside the serving loop — a stall."""
        yield
        if key not in self._warmed:
            self._warmed.add(key)
            self.stalls += 1
