"""Longest-common-prefix index over token-id sequences, and the KV
tier's metric handles.

Copies of :class:`RadixPrefixIndex` and ``kvtier_metrics`` from the JAX
package's ``models/llm/kvtier.py`` (the host KV arena, session journal
and transfer codec of that module are not ported yet: ROADMAP A1.2).  The
slot engine keeps one index per tenant over its slots' contexts and
finds the true longest reusable prefix with one trie walk: matching
compares tokens, so no hash can collide.  It observes its admission
latency under ``kvtier_admit_latency_seconds{path="cold"}``, as the
reference does without an arena.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from ...telemetry import get_registry

__all__ = ["RadixPrefixIndex", "kvtier_metrics"]


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
