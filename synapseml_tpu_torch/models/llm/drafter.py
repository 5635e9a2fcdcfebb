"""Prompt-lookup (n-gram suffix-match) self-drafting for speculative
decode: each slot's own prompt+generated ids are the draft source, and
no draft model runs.

A copy of the JAX package's ``models/llm/drafter.py`` (numpy only).  Per
slot, a table maps every n-gram of the context to the position right
after its latest earlier occurrence; a draft looks up the context's last
n tokens and proposes the tokens that followed.  The tables live on the
host and draft a variable span: nothing on a miss (the engine then runs
the plain one-token step), and on a hit only as many tokens as the
matched continuation has.  Verification in
:class:`~synapseml_tpu_torch.models.llm.slots.SlotEngine` keeps greedy
output exact, so a wrong draft costs only its verify positions.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

Key = Tuple[int, ...]
#: (latest, previous) continuation-start positions for one n-gram.  Two
#: generations are kept because the LATEST occurrence of the context's
#: own tail n-gram is the tail itself (registered when its last token
#: appended, continuation start == current length == nothing to read);
#: the PREVIOUS occurrence is the draft source.
Entry = Tuple[int, int]


class NgramDrafter:
    """Per-slot suffix-match draft tables over prompt+generated ids.

    ``ngram`` is the strongest (longest) match tried first;
    ``min_ngram`` the weakest fallback — a longer matched suffix is a
    higher-precision predictor, so the drafter prefers it and only
    falls back when the long table misses.  One table per n per slot.

    The owner (:class:`~synapseml_tpu_torch.models.llm.slots.SlotEngine`)
    calls :meth:`begin` at admit (prompt + first sampled token),
    :meth:`extend` after every committed token span, and :meth:`draft`
    before each decode step.  All ids come in as the engine's own
    ``ctx`` row — the drafter never copies the context, only indexes
    it.
    """

    def __init__(self, n_slots: int, ngram: int = 3, min_ngram: int = 2):
        if ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {ngram}")
        self.ngram = int(ngram)
        self.min_ngram = max(1, min(int(min_ngram), self.ngram))
        self._ns = tuple(range(self.ngram, self.min_ngram - 1, -1))
        self._tables: List[Dict[int, Dict[Key, Entry]]] = [
            {n: {} for n in self._ns} for _ in range(int(n_slots))]

    # -- table maintenance --------------------------------------------------
    def begin(self, slot: int, ids: np.ndarray, length: int) -> None:
        """(Re)build slot ``slot``'s tables from ``ids[:length]`` — the
        admit-time call, covering the prompt and the first sampled
        token.  A reused prefix needs no special casing: the tables are
        built from the TOKENS, which admit always has in full."""
        tables = self._tables[slot]
        for n in self._ns:
            tables[n].clear()
        self.extend(slot, ids, 0, length)

    def extend(self, slot: int, ids: np.ndarray, start: int,
               end: int) -> None:
        """Register every n-gram ENDING in ``[start, end)`` (tokens
        before ``start`` are already registered).  Called after each
        committed span; O((end-start) * n_levels) dict writes."""
        tables = self._tables[slot]
        for n in self._ns:
            table = tables[n]
            for i in range(max(start, n - 1), end):
                key = tuple(int(t) for t in ids[i - n + 1:i + 1])
                prev = table.get(key)
                # continuation starts at i+1; keep the displaced latest
                # as the fallback generation (see Entry)
                table[key] = (i + 1, prev[0] if prev else -1)

    def forget(self, slot: int) -> None:
        """Drop slot ``slot``'s tables (engine reset / reclaim)."""
        for table in self._tables[slot].values():
            table.clear()

    # -- drafting -----------------------------------------------------------
    def draft(self, slot: int, ids: np.ndarray, length: int,
              max_draft: int) -> np.ndarray:
        """Propose up to ``max_draft`` continuation tokens for a slot
        whose context is ``ids[:length]`` — the tokens that followed the
        latest EARLIER occurrence of the context's longest-matching
        suffix n-gram.  Returns an empty array on a miss (the engine
        then runs the plain one-token step: a miss costs nothing).

        When the matched occurrence sits ``span`` tokens back and the
        draft wants more than ``span`` tokens, the copy WRAPS around the
        matched block (``ids[src + i % span]``): a suffix that re-occurs
        ``span`` tokens before the tail means the text is locally
        ``span``-periodic, and extrapolating the period is the
        self-consistent continuation.  Cyclic text (token runs,
        repeated fields, degenerate greedy loops) is where prompt
        lookup earns most of its acceptance, and the LATEST occurrence
        — the best predictor otherwise — is by construction at most one
        period back, so without the wrap those drafts cap at one period
        per step.  A wrong extrapolation costs only its verify
        positions; acceptance-EWMA adaptation shrinks the cap when a
        slot's text stops cooperating."""
        if max_draft < 1:
            return np.empty(0, np.int32)
        tables = self._tables[slot]
        for n in self._ns:
            if length < n + 1:     # tail + at least one earlier token
                continue
            key = tuple(int(t) for t in ids[length - n:length])
            entry = tables[n].get(key)
            if entry is None:
                continue
            # the draft source is the newest occurrence whose
            # continuation has at least one KNOWN token (start < length;
            # the tail's own registration sits at start == length)
            src = next((p for p in entry if 0 <= p < length), -1)
            if src < 0:
                continue
            span = length - src
            idx = src + np.arange(max_draft) % span
            return np.asarray(ids[idx], np.int32)
        return np.empty(0, np.int32)
