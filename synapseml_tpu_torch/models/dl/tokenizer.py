"""Corpus-fitted word tokenizer and BERT WordPiece tokenizer for the text
classifier.

The PyTorch port's own copy of the JAX package's ``models/dl/tokenizer.py``
(pure Python and numpy; the port imports nothing of the JAX package).  Ids
and masks are the JAX package's exactly.  The reference uses HF
AutoTokenizer downloads (reference: DeepTextClassifier.py checkpoint
param, LitDeepTextModel.py:29); with no network the word tokenizer is
fitted on the training corpus: top-N words by frequency + hash buckets
for OOV — deterministic and serializable with the model.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PAD, CLS, SEP, UNK = 0, 1, 2, 3
_SPECIALS = 4
_WORD_RE = re.compile(r"[\w']+|[^\w\s]")


def _tokenize(text: str) -> List[str]:
    return _WORD_RE.findall(str(text).lower())


class WordTokenizer:
    def __init__(self, vocab: Dict[str, int], vocab_size: int,
                 num_hash_buckets: int = 0):
        self.vocab = vocab
        self.vocab_size = vocab_size
        self.num_hash_buckets = num_hash_buckets

    @staticmethod
    def fit(texts: Sequence[str], vocab_size: int = 8192,
            hash_fraction: float = 0.125) -> "WordTokenizer":
        from collections import Counter
        counts: Counter = Counter()
        for t in texts:
            counts.update(_tokenize(t))
        n_hash = max(int(vocab_size * hash_fraction), 16) \
            if len(counts) > vocab_size else 0
        # hash range must never reach into special ids or shrink the word
        # vocab below 1 entry
        n_hash = min(n_hash, max(vocab_size - _SPECIALS - 1, 0))
        n_vocab_words = vocab_size - _SPECIALS - n_hash
        vocab = {w: i + _SPECIALS
                 for i, (w, _) in enumerate(counts.most_common(n_vocab_words))}
        return WordTokenizer(vocab, vocab_size, n_hash)

    def _id(self, word: str) -> int:
        wid = self.vocab.get(word)
        if wid is not None:
            return wid
        if self.num_hash_buckets:
            import zlib  # stable across processes (unlike builtin hash)
            h = zlib.crc32(word.encode()) % self.num_hash_buckets
            return self.vocab_size - self.num_hash_buckets + h
        return UNK

    def encode(self, texts: Sequence[str],
               max_len: int = 128) -> Tuple[np.ndarray, np.ndarray]:
        """→ (ids (n, max_len) int32, mask (n, max_len) bool); layout
        [CLS] tokens... [SEP] pad..."""
        n = len(texts)
        ids = np.zeros((n, max_len), np.int32)
        mask = np.zeros((n, max_len), bool)
        for i, t in enumerate(texts):
            toks = [CLS] + [self._id(w) for w in _tokenize(t)][:max_len - 2] + [SEP]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = True
        return ids, mask

    def decode(self, ids) -> List[str]:
        """ids (n, T) → detokenized strings (special/hash ids dropped)."""
        inv = getattr(self, "_inverse_vocab", None)
        if inv is None:
            inv = {v: k for k, v in self.vocab.items()}
            self._inverse_vocab = inv
        out = []
        for row in np.asarray(ids):
            words = [inv[int(t)] for t in row if int(t) in inv]
            out.append(" ".join(words))
        return out

    def to_dict(self) -> dict:
        return {"kind": "word", "vocab": self.vocab,
                "vocab_size": self.vocab_size,
                "num_hash_buckets": self.num_hash_buckets}

    @staticmethod
    def from_dict(d: dict) -> "WordTokenizer":
        return WordTokenizer(dict(d["vocab"]), d["vocab_size"],
                             d["num_hash_buckets"])


class WordPieceTokenizer:
    """BERT WordPiece tokenizer over a standard ``vocab.txt``.

    The reference tokenizes with the checkpoint's own HF AutoTokenizer
    (reference: DeepTextClassifier.py:239); this is the self-contained
    equivalent for fine-tuning imported BERT checkpoints: basic
    lowercase+punct split then greedy longest-match-first subwords with the
    ``##`` continuation prefix — the WordPiece algorithm BERT vocabularies
    are built for.  Same encode/decode/to_dict surface as WordTokenizer so
    models serialize either interchangeably.
    """

    def __init__(self, vocab: Dict[str, int], lowercase: bool = True):
        self.vocab = vocab
        self.lowercase = lowercase
        self.vocab_size = max(vocab.values()) + 1
        self.pad_id = vocab.get("[PAD]", 0)
        self.cls_id = vocab.get("[CLS]", 1)
        self.sep_id = vocab.get("[SEP]", 2)
        self.unk_id = vocab.get("[UNK]", 3)

    @staticmethod
    def from_vocab_file(path: str, lowercase: bool = True) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return WordPieceTokenizer(vocab, lowercase)

    def _wordpiece(self, word: str) -> List[int]:
        if word in self.vocab:
            return [self.vocab[word]]
        pieces: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            pieces.append(cur)
            start = end
        return pieces

    def encode(self, texts: Sequence[str],
               max_len: int = 128) -> Tuple[np.ndarray, np.ndarray]:
        n = len(texts)
        ids = np.full((n, max_len), self.pad_id, np.int32)
        mask = np.zeros((n, max_len), bool)
        for i, t in enumerate(texts):
            t = str(t).lower() if self.lowercase else str(t)
            toks: List[int] = [self.cls_id]
            for w in _WORD_RE.findall(t):
                toks.extend(self._wordpiece(w))
                if len(toks) >= max_len - 1:
                    break
            toks = toks[:max_len - 1] + [self.sep_id]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = True
        return ids, mask

    def decode(self, ids) -> List[str]:
        inv = getattr(self, "_inverse_vocab", None)
        if inv is None:
            inv = {v: k for k, v in self.vocab.items()}
            self._inverse_vocab = inv
        special = {self.pad_id, self.cls_id, self.sep_id}
        out = []
        for row in np.asarray(ids):
            words: List[str] = []
            for t in row:
                t = int(t)
                if t in special or t not in inv:
                    continue
                piece = inv[t]
                if piece.startswith("##") and words:
                    words[-1] += piece[2:]
                else:
                    words.append(piece)
            out.append(" ".join(words))
        return out

    def to_dict(self) -> dict:
        return {"kind": "wordpiece", "vocab": self.vocab,
                "lowercase": self.lowercase}

    @staticmethod
    def from_dict(d: dict) -> "WordPieceTokenizer":
        return WordPieceTokenizer(dict(d["vocab"]), d.get("lowercase", True))


def tokenizer_from_dict(d: dict):
    """Deserialize either tokenizer kind (model payloads store the dict)."""
    if d.get("kind") == "wordpiece":
        return WordPieceTokenizer.from_dict(d)
    return WordTokenizer.from_dict(d)
