"""Session survivability: the radix prefix index, the host KV arena, the
KV transfer codec and the session journal.

The PyTorch port of the JAX package's ``models/llm/kvtier.py``.  One
invariant everywhere: **a degraded path falls back to cold prefill, it
never produces a wrong token.**

- :class:`RadixPrefixIndex` — a compressed radix trie over token-id
  sequences: ``longest_prefix`` returns the true longest common prefix
  against any indexed sequence (matching compares tokens, so no hash can
  collide).  The slot engine keeps one per tenant over its slots, and the
  arena one per tenant over its entries.
- :class:`HostKVArena` — a byte-budgeted host-RAM LRU of spilled K/V
  spans.  Entries hold the cache's native bytes (a bf16 cache spills as
  its uint16 bit patterns, ``tensor.view(torch.int16)``; an f32 cache as
  f32) plus a CRC32 each; a mismatch at fetch drops the entry and raises
  :class:`ChecksumError`, and the engine cold-prefills.
- :func:`pack_kv_transfer` / :func:`unpack_kv_transfer` — the wire frame
  of a K/V span (magic, a CRC-framed JSON header, per-row blobs with a CRC
  each).  A blob packed here is byte for byte the one the reference packs
  from the same rows, and either package unpacks the other's.
- :class:`SessionJournal` — an append-only, fsync'd, per-session log of
  ``prompt + committed token ids``; CRC-framed lines, torn-tail
  truncation at replay, kill-atomic rewrites (tmp + fsync + rename),
  a per-session byte cap with compaction and a marked truncation.  A
  journal written by either package replays in the other.

Fault sites (:mod:`synapseml_tpu_torch.resilience.faults`): every spill
walks ``kvtier.spill``, every fetch ``kvtier.restore``, every journal
append ``kvtier.journal_append``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading
import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...resilience.faults import get_faults
from ...telemetry import get_registry
from ...telemetry.flight import record as flight_record

__all__ = ["ChecksumError", "HostKVArena", "KVTIER_METRICS", "KVTransfer",
           "RadixPrefixIndex", "SessionJournal", "SessionState",
           "TRANSFER_MAGIC", "kvtier_metrics", "pack_kv_transfer",
           "token_prefix_hash", "unpack_kv_transfer"]

#: every metric this plane registers
KVTIER_METRICS = (
    "kvtier_spills_total",
    "kvtier_restores_total",
    "kvtier_arena_bytes",
    "kvtier_arena_evictions_total",
    "kvtier_admit_latency_seconds",
)

#: per-layer ``{"k", "v"}`` rows of shape (span, kv_heads, d_head), or
#: one stacked (layers, 2, span, kv_heads, d_head) tensor
Rows = Union[Sequence[Dict[str, Any]], torch.Tensor]


class ChecksumError(RuntimeError):
    """A spilled entry's stored CRC no longer matches its bytes (bit-rot,
    or an armed ``corrupt`` fault).  The entry is dropped and the caller
    cold-prefills; wrong K/V is never restored."""


@dataclasses.dataclass
class _KVTierMetrics:
    spills: Any
    restores: Any
    arena_bytes: Any
    arena_evictions: Any
    admit_latency: Any


def kvtier_metrics() -> _KVTierMetrics:
    """Get-or-create the plane's metric handles (the registry
    deduplicates by name, so every engine and loop shares one set)."""
    reg = get_registry()
    return _KVTierMetrics(
        spills=reg.counter(
            "kvtier_spills_total",
            "K/V spans spilled to the host arena", ("engine", "kind")),
        restores=reg.counter(
            "kvtier_restores_total",
            "warm-restore attempts by source (host arena / session "
            "journal) and outcome (ok, corrupt, miss, truncated — "
            "every non-ok outcome fell back to cold prefill)",
            ("engine", "source", "outcome")),
        arena_bytes=reg.gauge(
            "kvtier_arena_bytes",
            "bytes resident in the host KV arena", ("engine",)),
        arena_evictions=reg.counter(
            "kvtier_arena_evictions_total",
            "arena entries dropped (pressure = LRU tail under the byte "
            "budget, superseded = covered by a longer spill, corrupt = "
            "failed its checksum at fetch)", ("engine", "reason")),
        admit_latency=reg.histogram(
            "kvtier_admit_latency_seconds",
            "slot-admission latency by path (restore = host-arena span "
            "restored, cold = full prefill) — the restore-vs-cold "
            "comparison surface", ("engine", "path"),
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1.0, 2.5, 5.0)),
    )


class _RadixNode:
    __slots__ = ("edges", "refs")

    def __init__(self):
        #: first token -> (label tuple, child node); labels are
        #: compressed runs, split lazily on divergence
        self.edges: Dict[int, Tuple[Tuple[int, ...], "_RadixNode"]] = {}
        #: refs whose registered sequence passes through this node
        #: (i.e. shares the root→node path as a prefix)
        self.refs: set = set()


class RadixPrefixIndex:
    """Longest-common-prefix index over token-id sequences.

    ``insert(ids, ref)`` registers a sequence under an opaque hashable
    ref (a slot number, an arena entry key); re-inserting a ref
    replaces its sequence.  ``longest_prefix(query)`` returns
    ``(ref, lcp)`` — a ref whose registered sequence shares the longest
    prefix with the query, and that length.  Matching is exact by
    construction (the trie compares tokens, not hashes), so unlike the
    old single-hash candidate probe there is nothing to verify and no
    first-k-tokens blind spot: two sequences diverging inside the old
    hash window still share whatever true prefix they share.

    Not thread-safe; callers lock (the arena does, the engine is
    single-threaded by contract).
    """

    def __init__(self):
        self._root = _RadixNode()
        self._paths: Dict[Any, Tuple[int, ...]] = {}

    def __len__(self) -> int:
        return len(self._paths)

    def insert(self, ids, ref) -> None:
        seq = tuple(int(t) for t in ids)
        if self._paths.get(ref) == seq:
            return
        if ref in self._paths:
            self.remove(ref)
        self._paths[ref] = seq
        node = self._root
        node.refs.add(ref)
        i = 0
        while i < len(seq):
            edge = node.edges.get(seq[i])
            if edge is None:
                child = _RadixNode()
                child.refs.add(ref)
                node.edges[seq[i]] = (seq[i:], child)
                return
            label, child = edge
            m = _match_len(label, seq, i)
            if m == len(label):
                child.refs.add(ref)
                node, i = child, i + m
                continue
            # diverged (or exhausted) mid-edge: split it at m
            mid = _RadixNode()
            mid.refs = set(child.refs)
            mid.refs.add(ref)
            mid.edges[label[m]] = (label[m:], child)
            node.edges[seq[i]] = (label[:m], mid)
            if i + m < len(seq):
                tail = _RadixNode()
                tail.refs.add(ref)
                mid.edges[seq[i + m]] = (seq[i + m:], tail)
            node = mid
            return

    def remove(self, ref) -> None:
        seq = self._paths.pop(ref, None)
        if seq is None:
            return
        node = self._root
        node.refs.discard(ref)
        i = 0
        while i < len(seq):
            edge = node.edges.get(seq[i])
            if edge is None:
                return                      # defensive: path already gone
            label, child = edge
            child.refs.discard(ref)
            if not child.refs:
                del node.edges[seq[i]]
                return
            node, i = child, i + len(label)

    def clear(self) -> None:
        self._root = _RadixNode()
        self._paths.clear()

    def longest_prefix(self, ids, prefer=None) -> Tuple[Optional[Any], int]:
        """Deepest match for ``ids``: ``(ref, lcp)``, or ``(None, 0)``
        when nothing is indexed.  Ties at the deepest node prefer
        ``prefer`` when it is among the candidates (the engine's
        in-place multi-turn resume), else the smallest ref
        (deterministic)."""
        node, depth, i = self._root, 0, 0
        while i < len(ids):
            edge = node.edges.get(int(ids[i]))
            if edge is None:
                break
            label, child = edge
            m = _match_len(label, ids, i)
            depth += m
            node = child
            if m < len(label):
                break                      # partial edge: child's refs all
                #                            share exactly `depth` tokens
            i += m
        if not node.refs or depth == 0:
            return None, 0
        if prefer is not None and prefer in node.refs:
            return prefer, depth
        return min(node.refs, key=_ref_order), depth


def _match_len(label: Tuple[int, ...], seq, start: int) -> int:
    n = min(len(label), len(seq) - start)
    m = 0
    while m < n and label[m] == int(seq[start + m]):
        m += 1
    return m


def _ref_order(ref):
    return (str(type(ref)), repr(ref))


# ---------------------------------------------------------------------------
# Host KV arena
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _ArenaEntry:
    key: int
    ids: np.ndarray                 # (span,) int32: the tokens the K/V covers
    blob: bytes                     # packed K/V bytes (cache-native layout)
    crc: int
    shape: Tuple[int, ...]          # (layers, 2, span, kv_heads, d_head)
    dtype_name: str
    packed_bf16: bool               # stored as uint16 bit patterns
    nbytes: int
    tenant: str = "default"         # namespace: lookups never cross tenants


def _as_tensor(x) -> torch.Tensor:
    """A row as a CPU tensor (numpy arrays are wrapped, not copied)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(x))


def _stack_rows(rows: Rows) -> torch.Tensor:
    """Per-layer ``{"k", "v"}`` rows → one (L, 2, span, KH, DH) CPU tensor
    in the rows' dtype (a stacked tensor passes through)."""
    if isinstance(rows, torch.Tensor):
        return rows.detach().cpu()
    return torch.stack([torch.stack([_as_tensor(r["k"]), _as_tensor(r["v"])])
                        for r in rows])


class HostKVArena:
    """Byte-budgeted host-RAM LRU of spilled K/V spans, radix-indexed by
    token ids, one index per tenant.  Thread-safe: a serving loop spills
    from its own thread while another probes.

    ``put`` takes per-layer ``{"k", "v"}`` rows of shape ``(span,
    kv_heads, d_head)`` (tensors or numpy arrays, the cache's dtype) or
    one stacked ``(layers, 2, span, kv_heads, d_head)`` tensor, and packs
    them into one blob.  ``fetch`` verifies the CRC and returns per-layer
    CPU tensors sliced to the requested length, raising
    :class:`ChecksumError` (entry dropped) on a mismatch and
    ``KeyError`` on a miss; the engine maps both to a counted cold
    prefill."""

    def __init__(self, max_bytes: int = 256 * 1024 * 1024,
                 name: str = "llm"):
        self.max_bytes = int(max_bytes)
        self.name = name
        self._lock = threading.Lock()
        self._entries: "OrderedDict[int, _ArenaEntry]" = OrderedDict()
        #: one radix index per tenant: a lookup only ever matches a span
        #: the same tenant spilled
        self._radices: Dict[str, RadixPrefixIndex] = {}
        self._next_key = 0
        self._bytes = 0
        self._m = kvtier_metrics()
        self._m.arena_bytes.set(0, engine=self.name)

    @property
    def bytes_resident(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _radix_for(self, tenant: str) -> RadixPrefixIndex:
        # caller holds the lock
        idx = self._radices.get(tenant)
        if idx is None:
            idx = self._radices[tenant] = RadixPrefixIndex()
        return idx

    def put(self, ids, rows: Rows, kind: str = "retire",
            tenant: str = "default") -> Optional[int]:
        """Spill one K/V span into ``tenant``'s namespace → the entry key,
        or None when it was refused (over budget even alone, or an exact
        duplicate of what the same tenant already holds)."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        if len(ids) == 0 or (not isinstance(rows, torch.Tensor)
                             and not rows):
            return None
        faults = get_faults()
        stacked = _stack_rows(rows)
        blob, packed_bf16, dtype_name = _pack(stacked)
        crc = zlib.crc32(blob)
        # the fault site sits between checksum and store: a ``corrupt``
        # rule flips a stored byte and the fetch catches it (silent
        # bit-rot); ``kill`` dies here
        blob = faults.corrupt_point("kvtier.spill", blob, tenant=tenant)
        entry = _ArenaEntry(0, ids, blob, crc, tuple(stacked.shape),
                            dtype_name, packed_bf16, len(blob) + ids.nbytes,
                            tenant=str(tenant))
        with self._lock:
            if entry.nbytes > self.max_bytes:
                self._m.arena_evictions.inc(1, engine=self.name,
                                            reason="pressure")
                return None
            # a resident entry this one extends (or duplicates) is
            # superseded: every lookup it could win, this one wins at
            # least as long (within this tenant's index only)
            radix = self._radix_for(entry.tenant)
            old_key, lcp = radix.longest_prefix(ids)
            if old_key is not None:
                old = self._entries.get(old_key)
                if old is not None and lcp == len(old.ids):
                    if len(old.ids) == len(ids):
                        self._entries.move_to_end(old_key)
                        return None       # exact duplicate: refresh LRU
                    self._drop(old_key, "superseded")
            entry.key = self._next_key
            self._next_key += 1
            self._entries[entry.key] = entry
            self._bytes += entry.nbytes
            # re-fetched: _drop prunes an emptied tenant index
            self._radix_for(entry.tenant).insert(ids, entry.key)
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                tail_key = next(iter(self._entries))
                if tail_key == entry.key:
                    break
                self._drop(tail_key, "pressure")
            self._m.arena_bytes.set(self._bytes, engine=self.name)
        self._m.spills.inc(1, engine=self.name, kind=kind)
        flight_record("kvtier_spill", engine=self.name, spill_kind=kind,
                      tenant=entry.tenant, tokens=int(len(ids)),
                      bytes=entry.nbytes)
        return entry.key

    def _drop(self, key: int, reason: str) -> None:
        # caller holds the lock
        entry = self._entries.pop(key, None)
        if entry is None:
            return
        self._bytes -= entry.nbytes
        radix = self._radices.get(entry.tenant)
        if radix is not None:
            radix.remove(key)
            if not len(radix):
                del self._radices[entry.tenant]
        self._m.arena_evictions.inc(1, engine=self.name, reason=reason)
        self._m.arena_bytes.set(self._bytes, engine=self.name)

    def longest_prefix(self, ids,
                       tenant: str = "default") -> Tuple[Optional[int], int]:
        with self._lock:
            radix = self._radices.get(str(tenant))
            if radix is None:
                return None, 0
            key, lcp = radix.longest_prefix(ids)
            if key is not None:
                self._entries.move_to_end(key)
            return key, lcp

    def fetch(self, key: int, length: int,
              tenant: str = "default") -> List[Dict[str, torch.Tensor]]:
        """K/V rows ``[0, length)`` of entry ``key``: per-layer ``{"k",
        "v"}`` CPU tensors in the cache's dtype.  Raises ``KeyError`` (a
        miss, or a key of another tenant's namespace) or
        :class:`ChecksumError` (corrupt; the entry is removed)."""
        get_faults().kill_point("kvtier.restore", tenant=tenant)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry.tenant != str(tenant):
                raise KeyError(key)
            if zlib.crc32(entry.blob) != entry.crc:
                self._drop(key, "corrupt")
                raise ChecksumError(
                    f"arena entry {key} failed its checksum "
                    f"({len(entry.blob)} bytes, {len(entry.ids)} tokens)")
            self._entries.move_to_end(key)
            stacked = _unpack(entry.blob, entry.shape, entry.dtype_name,
                              entry.packed_bf16)
        length = int(length)
        return [{"k": stacked[layer, 0, :length],
                 "v": stacked[layer, 1, :length]}
                for layer in range(stacked.shape[0])]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._radices.clear()
            self._bytes = 0
            self._m.arena_bytes.set(0, engine=self.name)


#: torch dtypes that ship raw, by the numpy name the reference records
_RAW_DTYPES = {torch.float32: "float32", torch.float16: "float16",
               torch.float64: "float64"}


def _pack(t: torch.Tensor) -> Tuple[bytes, bool, str]:
    """Cache-native serialization: bf16 ships as its uint16 bit patterns
    (lossless at 2 bytes an element), every other type raw.  An f32 cache
    is never rounded through bf16."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().tobytes(), True, "bfloat16"
    if t.dtype not in _RAW_DTYPES:
        raise TypeError(f"cannot spill a {t.dtype} cache")
    return t.numpy().tobytes(), False, _RAW_DTYPES[t.dtype]


def _unpack(blob: bytes, shape: Tuple[int, ...], dtype_name: str,
            packed_bf16: bool) -> torch.Tensor:
    if packed_bf16:
        raw = np.frombuffer(blob, np.int16).reshape(shape).copy()
        return torch.from_numpy(raw).view(torch.bfloat16)
    arr = np.frombuffer(blob, np.dtype(dtype_name)).reshape(shape).copy()
    return torch.from_numpy(arr)


# ---------------------------------------------------------------------------
# KV transfer framing
# ---------------------------------------------------------------------------

#: wire magic of a packed KV transfer (the frame's version)
TRANSFER_MAGIC = b"SMLKV1\n"


@dataclasses.dataclass
class KVTransfer:
    """A decoded transfer: the prompt ids the K/V covers, per-layer
    ``{"k", "v"}`` CPU tensors in the cache's dtype, and the identity
    triple (session, tenant, token-prefix hash).  Produced only by
    :func:`unpack_kv_transfer`, so every row passed its CRC and the
    prefix hash matched the ids."""
    session: Optional[str]
    tenant: str
    ids: List[int]
    rows: List[Dict[str, torch.Tensor]]
    prefix_hash: str


def token_prefix_hash(ids) -> str:
    """Order-sensitive identity of a token prefix: sha1 over the int32
    byte stream, 16 hex characters."""
    arr = np.asarray(ids, np.int32).reshape(-1)
    return hashlib.sha1(arr.tobytes()).hexdigest()[:16]


def pack_kv_transfer(ids, rows: Sequence[Dict[str, Any]],
                     session: Optional[str] = None,
                     tenant: str = "default") -> bytes:
    """Frame one span as wire bytes: the magic, a CRC-framed JSON header
    line (session, tenant, ids, prefix hash, the row shape and dtype, and
    a CRC32 per row), then the per-layer row blobs in the arena's packing
    (bf16 as uint16 bit patterns)."""
    ids = np.asarray(ids, np.int32).reshape(-1)
    if len(ids) == 0 or not rows:
        raise ValueError("a KV transfer needs a non-empty prompt and rows")
    blobs: List[bytes] = []
    crcs: List[int] = []
    lens: List[int] = []
    shape: Optional[Tuple[int, ...]] = None
    dtype_name = ""
    packed_bf16 = False
    for row in rows:
        stacked = torch.stack([_as_tensor(row["k"]),
                               _as_tensor(row["v"])])  # (2, span, KH, DH)
        blob, packed_bf16, dtype_name = _pack(stacked)
        if shape is None:
            shape = tuple(stacked.shape)
        elif tuple(stacked.shape) != tuple(shape):
            raise ValueError("KV transfer rows must share one shape")
        blobs.append(blob)
        crcs.append(zlib.crc32(blob))
        lens.append(len(blob))
    header = {
        "session": None if session is None else str(session),
        "tenant": str(tenant),
        "ids": [int(t) for t in ids],
        "prefix_hash": token_prefix_hash(ids),
        "shape": [int(d) for d in shape],
        "dtype": dtype_name,
        "packed_bf16": bool(packed_bf16),
        "row_bytes": lens,
        "row_crcs": crcs,
    }
    return TRANSFER_MAGIC + SessionJournal._frame(header) + b"".join(blobs)


def unpack_kv_transfer(blob: bytes) -> KVTransfer:
    """Decode and verify a frame of :func:`pack_kv_transfer`.  Raises
    ``ValueError`` when the bytes are not a KV transfer (wrong magic, no
    header line) and :class:`ChecksumError` when they are a damaged one
    (header or row CRC mismatch, a short body, a prefix hash that no
    longer matches the ids)."""
    if not blob.startswith(TRANSFER_MAGIC):
        raise ValueError("not a KV transfer frame (bad magic)")
    rest = blob[len(TRANSFER_MAGIC):]
    nl = rest.find(b"\n")
    if nl < 0:
        raise ValueError("KV transfer frame has no header line")
    line, body = rest[:nl].decode("utf-8", "replace"), rest[nl + 1:]
    crc_hex, _, text = line.partition(" ")
    try:
        want_crc = int(crc_hex, 16)
    except ValueError:
        raise ChecksumError("KV transfer header frame is malformed")
    if zlib.crc32(text.encode()) != want_crc:
        raise ChecksumError("KV transfer header failed its checksum")
    header = json.loads(text)
    ids = [int(t) for t in header["ids"]]
    if token_prefix_hash(ids) != header["prefix_hash"]:
        raise ChecksumError("KV transfer token-prefix hash mismatch")
    lens = [int(n) for n in header["row_bytes"]]
    crcs = [int(c) for c in header["row_crcs"]]
    if len(lens) != len(crcs) or len(body) != sum(lens):
        raise ChecksumError(
            f"KV transfer body is torn ({len(body)} bytes, "
            f"expected {sum(lens)})")
    shape = tuple(int(d) for d in header["shape"])
    rows: List[Dict[str, torch.Tensor]] = []
    off = 0
    for i, (n, crc) in enumerate(zip(lens, crcs)):
        chunk = body[off:off + n]
        off += n
        if zlib.crc32(chunk) != crc:
            raise ChecksumError(f"KV transfer row {i} failed its checksum")
        stacked = _unpack(chunk, shape, header["dtype"],
                          bool(header["packed_bf16"]))
        rows.append({"k": stacked[0], "v": stacked[1]})
    return KVTransfer(session=header["session"], tenant=header["tenant"],
                      ids=ids, rows=rows,
                      prefix_hash=str(header["prefix_hash"]))


# ---------------------------------------------------------------------------
# Session journal
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SessionState:
    """What :meth:`SessionJournal.replay` rebuilds: the turn's prompt, the
    tokens committed so far, the turn's token budget, and how many oldest
    tokens the size cap dropped (``truncated > 0``: the ids are a suffix,
    a token-exact resume is impossible).  ``tenant`` is the namespace the
    turn was journaled under."""
    session: str
    prompt: List[int]
    committed: List[int]
    max_new: int
    truncated: int = 0
    tenant: str = "default"

    @property
    def ids(self) -> List[int]:
        return list(self.prompt) + list(self.committed)


class SessionJournal:
    """Append-only, fsync'd, CRC-framed per-session conversation log.  One
    file per session under ``root``; each line is ``"%08x %s\\n" %
    (crc32(json), json)``.  A torn tail fails its CRC and :meth:`replay`
    truncates the file to the last valid record; ``begin``/``compact``
    rewrite the whole file through mkstemp + fsync + rename."""

    def __init__(self, root: str, max_bytes_per_session: int = 256 * 1024,
                 fsync: bool = True, name: str = "llm"):
        self.root = str(root)
        self.max_bytes_per_session = int(max_bytes_per_session)
        self.fsync = bool(fsync)
        self.name = name
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        #: the serving loop counts its replay outcomes through these
        self.metrics = kvtier_metrics()

    def path(self, session: str, tenant: str = "default") -> str:
        """The session's file, namespaced by tenant (the digest covers
        ``tenant NUL session``)."""
        digest = hashlib.sha1(
            f"{tenant}\x00{session}".encode()).hexdigest()[:24]
        return os.path.join(self.root, f"{digest}.jnl")

    # -- writes ------------------------------------------------------------
    def begin(self, session: str, prompt_ids, max_new: int,
              tenant: str = "default") -> None:
        """Start (or reset) a turn: the state becomes ``prompt_ids`` with
        nothing committed (an atomic rewrite)."""
        state = SessionState(str(session), [int(t) for t in prompt_ids], [],
                             int(max_new), tenant=str(tenant))
        with self._lock:
            self._write_state(state)

    def append_tokens(self, session: str, tokens,
                      tenant: str = "default") -> None:
        """Append committed tokens, fsync'd before return.  Over the
        per-session cap the journal compacts in place, and truncates the
        oldest tokens (marked) only when the conversation itself outgrows
        the cap."""
        rec = {"op": "tokens", "ids": [int(t) for t in tokens]}
        with self._lock:
            self._append(session, rec, tenant=str(tenant))
            path = self.path(str(session), str(tenant))
            try:
                size = os.path.getsize(path)
            except OSError:
                return
            if size > self.max_bytes_per_session:
                self._compact(str(session), str(tenant))

    def compact(self, session: str, tenant: str = "default") -> None:
        """Consolidate the session's records into one state record (at
        retirement)."""
        with self._lock:
            self._compact(str(session), str(tenant))

    retire = compact

    def drop(self, session: str, tenant: str = "default") -> None:
        with self._lock:
            try:
                os.unlink(self.path(str(session), str(tenant)))
            except OSError:
                pass

    # -- replay ------------------------------------------------------------
    def replay(self, session: str,
               tenant: str = "default") -> Optional[SessionState]:
        """Rebuild the session's state, truncating the file to the last
        valid record when its tail is torn or a record is corrupt.  A
        session id under another tenant answers None."""
        with self._lock:
            state = self._replay_path(self.path(str(session), str(tenant)),
                                      truncate=True)
            if state is not None and state.tenant != str(tenant):
                return None
            return state

    def sessions(self) -> List[str]:
        """Names of every replayable session in the journal root."""
        out = []
        for fn in sorted(os.listdir(self.root)):
            if not fn.endswith(".jnl"):
                continue
            state = self._replay_path(os.path.join(self.root, fn))
            if state is not None:
                out.append(state.session)
        return out

    # -- internals ---------------------------------------------------------
    @staticmethod
    def _frame(rec: Dict[str, Any]) -> bytes:
        text = json.dumps(rec, separators=(",", ":"), sort_keys=True)
        return (f"{zlib.crc32(text.encode()):08x} {text}\n").encode()

    def _append(self, session: str, rec: Dict[str, Any],
                tenant: str = "default") -> None:
        line = self._frame(rec)
        # the fault site covers the whole append: ``kill`` dies with the
        # record unwritten, ``corrupt`` flips a stored byte
        line = get_faults().corrupt_point("kvtier.journal_append", line,
                                          tenant=tenant)
        fd = os.open(self.path(session, tenant),
                     os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            os.write(fd, line)
            if self.fsync:
                os.fsync(fd)
        finally:
            os.close(fd)

    def _write_state(self, state: SessionState) -> None:
        rec = {"op": "state", "session": state.session,
               "prompt": state.prompt, "committed": state.committed,
               "max_new": state.max_new, "truncated": state.truncated,
               "tenant": state.tenant}
        path = self.path(state.session, state.tenant)
        fd, tmp = tempfile.mkstemp(dir=self.root,
                                   prefix=os.path.basename(path) + ".tmp.")
        try:
            os.write(fd, self._frame(rec))
            if self.fsync:
                os.fsync(fd)
            os.close(fd)
            os.chmod(tmp, 0o644)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.close(fd)
            except OSError:
                pass
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        if self.fsync:
            try:
                dfd = os.open(self.root, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:  # pragma: no cover: no directory fsync
                pass

    def _compact(self, session: str, tenant: str = "default") -> None:
        state = self._replay_path(self.path(session, tenant), truncate=True)
        if state is None:
            return
        # oldest-token truncation only when the conversation itself
        # outgrows the cap (~6 bytes a framed token), and marked
        budget = max(16, self.max_bytes_per_session // 8)
        ids = state.ids
        if len(ids) > budget:
            drop = len(ids) - budget
            state.truncated += drop
            keep_prompt = state.prompt[drop:]
            extra = drop - (len(state.prompt) - len(keep_prompt))
            state.prompt = keep_prompt
            if extra > 0:
                state.committed = state.committed[extra:]
            flight_record("kvtier_journal_truncated", engine=self.name,
                          session=session, dropped=drop)
        self._write_state(state)

    def _replay_path(self, path: str,
                     truncate: bool = False) -> Optional[SessionState]:
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return None
        state: Optional[SessionState] = None
        valid_end = 0
        pos = 0
        while pos < len(data):
            nl = data.find(b"\n", pos)
            if nl < 0:
                break                          # torn tail (no newline)
            rec = self._parse(data[pos:nl])
            if rec is None:
                break                          # corrupt record: stop here
            pos = nl + 1
            valid_end = pos
            if rec.get("op") == "state":
                state = SessionState(
                    str(rec.get("session", "")),
                    [int(t) for t in rec.get("prompt", [])],
                    [int(t) for t in rec.get("committed", [])],
                    int(rec.get("max_new", 0)),
                    int(rec.get("truncated", 0)),
                    tenant=str(rec.get("tenant", "default")))
            elif rec.get("op") == "tokens" and state is not None:
                state.committed.extend(int(t) for t in rec.get("ids", []))
        if truncate and valid_end < len(data):
            flight_record("kvtier_journal_torn", engine=self.name,
                          path=path, dropped_bytes=len(data) - valid_end)
            try:
                with open(path, "r+b") as f:
                    f.truncate(valid_end)
            except OSError:
                pass
        return state

    @staticmethod
    def _parse(line: bytes) -> Optional[Dict[str, Any]]:
        if len(line) < 10 or line[8:9] != b" ":
            return None
        try:
            crc = int(line[:8], 16)
            body = line[9:]
            if zlib.crc32(body) != crc:
                return None
            rec = json.loads(body.decode())
        except (ValueError, UnicodeDecodeError):
            return None
        return rec if isinstance(rec, dict) else None
