"""Core runtime utilities of the PyTorch port, a copy of the JAX package's
``core/utils.py``.

Analogues of the reference's ``core/utils`` package:
- :class:`StopWatch` — core/utils/StopWatch.scala
- :func:`retry_with_timeout` — core/utils/FaultToleranceUtils.scala:9-31
  (retry backoffs 0/100/200/500 ms, per-attempt timeout)
- :func:`using` — core/env/StreamUtilities.using resource bracket
- :class:`SharedVariable` — per-process lazy singleton
  (io/http/SharedVariable.scala:17,36; used for per-executor shared state
  like LightGBM's SharedState, SharedState.scala:12-89)
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import re
import threading
import time
from typing import Callable, Generic, Iterable, List, Optional, TypeVar

__all__ = ["DEFAULT_BACKOFFS_MS", "retry_with_timeout", "retry", "using",
           "StopWatch", "SharedVariable", "KahanSum", "assert_models_equal",
           "TEMPLATE_RE", "interpolate_template"]

T = TypeVar("T")

DEFAULT_BACKOFFS_MS = (0, 100, 200, 500)


def retry_with_timeout(fn: Callable[[], T],
                       timeout_s: Optional[float] = None,
                       backoffs_ms: Iterable[int] = DEFAULT_BACKOFFS_MS) -> T:
    """Run ``fn`` with per-attempt timeout, retrying on failure with the
    reference's backoff schedule."""
    from ..resilience.faults import get_faults
    backoffs = list(backoffs_ms)
    last_exc: Optional[BaseException] = None
    for i, backoff in enumerate(backoffs):
        if backoff:
            # routed through the fault registry so the schedule is
            # recorded alongside every other backoff in the stack
            get_faults().sleep(backoff / 1e3, site="core.retry")
        try:
            if timeout_s is None:
                return fn()
            pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
            try:
                return pool.submit(fn).result(timeout=timeout_s)
            finally:
                # wait=False: a hung fn must not block the caller past the
                # timeout; the orphaned worker thread dies with the process
                pool.shutdown(wait=False)
        except BaseException as e:  # noqa: BLE001 - retry everything like the reference
            last_exc = e
    raise RuntimeError(f"retry_with_timeout exhausted {len(backoffs)} attempts") from last_exc


def retry(fn: Callable[[], T], times: List[int]) -> T:
    """HandlingUtils.retry analogue: try, sleep head of list, recurse on tail
    — i.e. len(times)+1 attempts, last error rethrown."""
    from ..resilience.faults import get_faults
    for backoff in times:
        try:
            return fn()
        except BaseException:
            get_faults().sleep(backoff / 1e3, site="core.retry")
    return fn()


@contextlib.contextmanager
def using(resource):
    """StreamUtilities.using: close() guaranteed."""
    try:
        yield resource
    finally:
        close = getattr(resource, "close", None)
        if close:
            close()


class StopWatch:
    """Accumulating stopwatch (reference: core/utils/StopWatch.scala)."""

    def __init__(self):
        self._elapsed_ns = 0
        self._start: Optional[int] = None

    def start(self) -> None:
        self._start = time.perf_counter_ns()

    def stop(self) -> None:
        if self._start is not None:
            self._elapsed_ns += time.perf_counter_ns() - self._start
            self._start = None

    def restart(self) -> None:
        self._elapsed_ns = 0
        self.start()

    @contextlib.contextmanager
    def measure(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    @property
    def elapsed_ns(self) -> int:
        running = (time.perf_counter_ns() - self._start) if self._start is not None else 0
        return self._elapsed_ns + running

    @property
    def elapsed_ms(self) -> float:
        return self.elapsed_ns / 1e6

    @property
    def elapsed_s(self) -> float:
        return self.elapsed_ns / 1e9


class SharedVariable(Generic[T]):
    """Lazily-constructed per-process singleton value with double-checked
    locking (reference: io/http/SharedVariable.scala,
    lightgbm SharedState main-worker election SharedState.scala:53-61)."""

    def __init__(self, ctor: Callable[[], T]):
        self._ctor = ctor
        self._lock = threading.Lock()
        self._value: Optional[T] = None
        self._built = False

    def get(self) -> T:
        if not self._built:
            with self._lock:
                if not self._built:
                    self._value = self._ctor()
                    self._built = True
        return self._value  # type: ignore[return-value]

    def reset(self) -> None:
        with self._lock:
            self._value = None
            self._built = False


class KahanSum:
    """Compensated summation (reference: vw/KahanSum.scala:68)."""

    __slots__ = ("_sum", "_c")

    def __init__(self, value: float = 0.0):
        self._sum = float(value)
        self._c = 0.0

    def add(self, x: float) -> "KahanSum":
        y = x - self._c
        t = self._sum + y
        self._c = (t - self._sum) - y
        self._sum = t
        return self

    @property
    def value(self) -> float:
        return self._sum

    def __iadd__(self, x: float) -> "KahanSum":
        return self.add(x)


def assert_models_equal(m1, m2, loose_params: Iterable[str] = ()) -> None:
    """Assert two pipeline stages have the same class and param values.

    The port's analogue of the reference's save/load equality check
    (core/utils/ModelEquality.scala:15-50): identical class, identical
    param-name sets, and equal values — except params named in
    ``loose_params`` (the reference hard-codes uid-bearing column names
    and randomly assigned ports), which only need matching presence.
    Numpy-array values compare with allclose.
    """
    import numpy as np

    if type(m1) is not type(m2):
        raise AssertionError(f"{type(m1)} != {type(m2)}")
    names1 = {p.name for p in m1.params}
    names2 = {p.name for p in m2.params}
    if names1 != names2:
        raise AssertionError(f"param sets differ: {names1 ^ names2}")
    loose = set(loose_params)
    for name in sorted(names1):
        if name in loose:
            continue
        v1, v2 = m1.get(name), m2.get(name)
        if isinstance(v1, np.ndarray) or isinstance(v2, np.ndarray):
            a1, a2 = np.asarray(v1), np.asarray(v2)
            if a1.shape != a2.shape:
                raise AssertionError(f"param {name}: shape {a1.shape} != {a2.shape}")
            if a1.dtype.kind in "fc":
                ok = np.allclose(a1, a2, equal_nan=True)
            else:
                ok = bool(np.array_equal(a1, a2))
            if not ok:
                raise AssertionError(f"param {name}: arrays differ")
        elif callable(v1) and callable(v2):
            continue  # UDFs compare by presence only, like ComplexParam
        elif (v1 is not None and v2 is not None
              and type(v1) is type(v2)
              and type(v1).__eq__ is object.__eq__):
            continue  # complex values with identity equality: presence only
        elif (isinstance(v1, float) and isinstance(v2, float)
              and np.isnan(v1) and np.isnan(v2)):
            continue  # NaN scalars match, like equal_nan for arrays
        elif v1 != v2:
            raise AssertionError(f"param {name}: {v1!r} != {v2!r}")


#: ``{column}`` interpolation slots of the prompt-templating stages
#: (models.llm.LLMTransformer)
TEMPLATE_RE = re.compile(r"\{(\w+)\}")


def interpolate_template(template: str, lookup) -> str:
    """Replace ``{name}`` slots via ``lookup(name) -> Optional[str]``;
    slots whose lookup returns None (and literal braces) pass through."""
    def sub(m):
        v = lookup(m.group(1))
        return m.group(0) if v is None else str(v)
    return TEMPLATE_RE.sub(sub, template)
