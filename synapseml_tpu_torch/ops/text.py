"""Text featurization stages.

Re-designs the reference's ``featurize.text`` package (reference:
core/src/main/scala/com/microsoft/azure/synapse/ml/featurize/text/
TextFeaturizer.scala, MultiNGram.scala, PageSplitter.scala): tokenize →
n-grams → hashing TF → IDF, producing dense hashed vectors instead of
Spark sparse vectors.  The PyTorch port's copy of the JAX package's
``ops/text.py``, over the port's ``core/hashing.py`` (the same murmur3
hashes).
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

import numpy as np

from ..core.dataset import Dataset
from ..core.hashing import hash_features, murmurhash3_32
from ..core.params import (BoolParam, IntParam, ListParam, StringParam)
from ..core.pipeline import Estimator, Model, Transformer

_DEFAULT_STOP_WORDS = frozenset(
    "a an and are as at be by for from has he in is it its of on that the to "
    "was were will with".split())


def _tokenize(text: str, pattern: str, gaps: bool, lower: bool,
              min_len: int) -> List[str]:
    s = str(text)
    if lower:
        s = s.lower()
    toks = re.split(pattern, s) if gaps else re.findall(pattern, s)
    return [t for t in toks if len(t) >= min_len]


def _ngrams(tokens: Sequence[str], n: int) -> List[str]:
    if n <= 1:
        return list(tokens)
    return [" ".join(tokens[i:i + n]) for i in range(len(tokens) - n + 1)]


class _TextFeaturizerParams:
    """Shared param surface + term pipeline for estimator and model."""

    inputCol = StringParam(doc="text column")
    outputCol = StringParam(doc="feature vector column", default="features")
    useTokenizer = BoolParam(doc="tokenize with regex", default=True)
    tokenizerPattern = StringParam(doc="regex for tokens", default=r"\s+")
    tokenizerGaps = BoolParam(doc="pattern matches gaps (split) vs tokens",
                              default=True)
    toLowercase = BoolParam(doc="lowercase before tokenizing", default=True)
    minTokenLength = IntParam(doc="drop shorter tokens", default=0)
    useStopWordsRemover = BoolParam(doc="remove stop words", default=False)
    caseSensitiveStopWords = BoolParam(doc="case sensitive stop words",
                                       default=False)
    defaultStopWordLanguage = StringParam(doc="parity: stop word language",
                                          default="english")
    useNGram = BoolParam(doc="emit n-grams", default=False)
    nGramLength = IntParam(doc="n-gram order", default=2)
    binary = BoolParam(doc="binary TF instead of counts", default=False)
    # the reference defaults to 2^18 sparse; the vectors here are dense,
    # so the default dimension is 4096
    numFeatures = IntParam(doc="hashing dimension (dense)", default=1 << 12)
    useIDF = BoolParam(doc="rescale by inverse document frequency",
                       default=True)
    minDocFreq = IntParam(doc="min docs for IDF term", default=1)

    # -- shared with the model ---------------------------------------------
    def _terms(self, text: str) -> List[str]:
        toks = (_tokenize(text, self.tokenizerPattern, self.tokenizerGaps,
                          self.toLowercase, self.minTokenLength)
                if self.useTokenizer else [str(text)])
        if self.useStopWordsRemover:
            if self.caseSensitiveStopWords:
                toks = [t for t in toks if t not in _DEFAULT_STOP_WORDS]
            else:
                toks = [t for t in toks if t.lower() not in _DEFAULT_STOP_WORDS]
        if self.useNGram:
            toks = _ngrams(toks, self.nGramLength)
        return toks

    def _tf_matrix(self, col: np.ndarray) -> np.ndarray:
        dim = self.numFeatures
        rows = np.zeros((len(col), dim), dtype=np.float64)
        for i, text in enumerate(col):
            for t in self._terms(text):
                rows[i, murmurhash3_32(t, 0) % dim] += 1.0
        if self.binary:
            rows = (rows > 0).astype(np.float64)
        return rows


class TextFeaturizer(_TextFeaturizerParams, Estimator):
    """tokenize → stop-words → n-grams → hashing TF → IDF, one call
    (reference: featurize/text/TextFeaturizer.scala — the same param
    surface: useTokenizer/useStopWordsRemover/useNGram/useIDF/numFeatures)."""

    def __init__(self, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if inputCol is not None:
            self.set("inputCol", inputCol)
        if outputCol is not None:
            self.set("outputCol", outputCol)

    def _fit(self, ds: Dataset) -> "TextFeaturizerModel":
        tf = self._tf_matrix(ds[self.inputCol])
        if self.useIDF:
            n_docs = tf.shape[0]
            df = (tf > 0).sum(axis=0)
            idf = np.where(df >= self.minDocFreq,
                           np.log((n_docs + 1.0) / (df + 1.0)), 0.0)
        else:
            idf = None
        model = TextFeaturizerModel()
        model._copy_values_from(self)
        model.idf_vector = idf
        return model


class TextFeaturizerModel(_TextFeaturizerParams, Model):
    """Fitted featurizer carrying the IDF vector."""

    idf_vector: Optional[np.ndarray] = None

    def _transform(self, ds: Dataset) -> Dataset:
        tf = self._tf_matrix(ds[self.inputCol])
        if self.useIDF and self.idf_vector is not None:
            tf = tf * self.idf_vector
        return ds.with_column(self.outputCol, [row for row in tf])

    def _save_extra(self, path: str) -> None:
        import os
        if self.idf_vector is not None:
            np.save(os.path.join(path, "idf.npy"), self.idf_vector)

    def _load_extra(self, path: str) -> None:
        import os
        p = os.path.join(path, "idf.npy")
        self.idf_vector = np.load(p) if os.path.exists(p) else None


class MultiNGram(Transformer):
    """Concatenate n-grams of several orders into one token-list column
    (reference: featurize/text/MultiNGram.scala)."""

    inputCol = StringParam(doc="token-list column")
    outputCol = StringParam(doc="n-gram list output column")
    lengths = ListParam(doc="n-gram orders", default=None)

    def __init__(self, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None,
                 lengths: Optional[Sequence[int]] = None, **kw):
        super().__init__(**kw)
        if inputCol is not None:
            self.set("inputCol", inputCol)
        if outputCol is not None:
            self.set("outputCol", outputCol)
        if lengths is not None:
            self.set("lengths", [int(x) for x in lengths])

    def _transform(self, ds: Dataset) -> Dataset:
        lengths = [int(x) for x in (self.lengths or [2])]
        col = ds[self.inputCol]
        out = []
        for tokens in col:
            toks = list(tokens)
            grams: List[str] = []
            for n in lengths:
                grams.extend(_ngrams(toks, n))
            out.append(grams)
        return ds.with_column(self.outputCol, out)


class PageSplitter(Transformer):
    """Split long documents into page strings within [min,max] character
    bounds, preferring word boundaries
    (reference: featurize/text/PageSplitter.scala — boundaryRegex,
    maximumPageLength, minimumPageLength)."""

    inputCol = StringParam(doc="text column")
    outputCol = StringParam(doc="list-of-pages output column")
    maximumPageLength = IntParam(doc="max chars per page", default=5000)
    minimumPageLength = IntParam(doc="min chars before breaking at a "
                                 "boundary", default=4500)
    boundaryRegex = StringParam(doc="preferred break pattern", default=r"\s")

    def __init__(self, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if inputCol is not None:
            self.set("inputCol", inputCol)
        if outputCol is not None:
            self.set("outputCol", outputCol)

    def _split(self, text: str) -> List[str]:
        s = str(text)
        lo, hi = self.minimumPageLength, self.maximumPageLength
        pat = re.compile(self.boundaryRegex)
        pages: List[str] = []
        while len(s) > hi:
            # break at last boundary in [lo, hi); hard-break at hi otherwise
            window = s[lo:hi]
            matches = list(pat.finditer(window))
            cut = lo + matches[-1].end() if matches else hi
            pages.append(s[:cut])
            s = s[cut:]
        if s or not pages:
            pages.append(s)
        return pages

    def _transform(self, ds: Dataset) -> Dataset:
        col = ds[self.inputCol]
        return ds.with_column(self.outputCol, [self._split(t) for t in col])
