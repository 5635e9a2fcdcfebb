"""Raw VW-format example learners (reference:
vw/.../VowpalWabbitGeneric.scala:1-131 — an Estimator driven by VW text
examples like ``0 |a b c``, learning via ``vw.learnFromString`` per row —
and VowpalWabbitGenericProgressive, which emits the 1-step-ahead
prediction for every row while learning).

The PyTorch port of the JAX package's ``models/online/generic.py``: the
text lines are parsed on the host into hashed dense vectors (murmur with
namespace prefix, matching HashingFeaturizer's convention) by the native
parser (``synapseml_tpu_torch/native/textproc.cpp``; a failed build
raises), then the learn loop is :func:`.sgd.train_sgd` on the ``device``
param, as for the other online learners.  :func:`parse_vw_line` and
:func:`vectorize_vw_lines_plain` are the pure-Python plain version of
the native path.  Progressive validation predicts each batch with the
weights before its update.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...core.dataset import Dataset
from ...core.hashing import murmurhash3_32
from ...core.params import IntParam, PyObjectParam, StringParam
from ...core.pipeline import Estimator, Model, Transformer
from ...device import resolve_device
from .estimators import _OnlineSGDParams
from .sgd import SGDState, _check_mesh, predict_margin, state_to, train_sgd


def parse_vw_line(line: str) -> Tuple[Optional[float], float,
                                      List[Tuple[str, str, float]]]:
    """Parse one VW-format example into (label, importance, features).

    Features are (namespace, feature_name, value) triples.  Supported
    grammar (the subset the reference's test corpus uses):
    ``[label [importance]] |ns[:w] f[:v] ... |ns2 ...``.
    """
    head, _, rest = line.partition("|")
    label: Optional[float] = None
    importance = 1.0
    head_toks = head.split()
    if head_toks:
        try:
            label = float(head_toks[0])
        except ValueError:
            label = None  # tag-only head (e.g. "'row1 |f x") — unlabeled
        if label is not None and len(head_toks) > 1:
            try:
                importance = float(head_toks[1])
            except ValueError:
                pass  # a tag, not an importance weight
    feats: List[Tuple[str, str, float]] = []
    for seg in rest.split("|") if rest else []:
        toks = seg.split()
        if not toks:
            continue
        ns_weight = 1.0
        # a namespace token is attached to the '|' (no leading space)
        if seg[:1] not in (" ", "\t"):
            ns_tok = toks[0]
            toks = toks[1:]
            ns, _, w = ns_tok.partition(":")
            if w:
                try:
                    ns_weight = float(w)
                except ValueError:
                    pass
        else:
            ns = ""
        for tok in toks:
            name, _, val = tok.partition(":")
            try:
                value = float(val) if val else 1.0
            except ValueError:
                value = 1.0
            feats.append((ns, name, value * ns_weight))
    return label, importance, feats


def vectorize_vw_lines(lines, num_bits: int, seed: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Hash parsed VW lines into a dense (n, 2^bits) matrix + labels +
    importance weights (hashing matches VowpalWabbitMurmurWithPrefix
    semantics: feature index = murmur(ns + name)), with the native C++
    parser and hasher (the reference's VW parse path is native C++ behind
    JNI; this one is ctypes)."""
    from ...native import coo_densify, vw_parse_batch
    rows, idxs, vals, y, w, _has = vw_parse_batch(lines, num_bits, seed)
    x = np.zeros((len(lines), 1 << num_bits), np.float32)
    coo_densify(rows, idxs, vals, x)
    return x, y, w


def vectorize_vw_lines_plain(lines, num_bits: int, seed: int
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The plain version of :func:`vectorize_vw_lines`:
    :func:`parse_vw_line` and the Python murmur hash, line by line."""
    dim = 1 << num_bits
    n = len(lines)
    x = np.zeros((n, dim), np.float32)
    y = np.zeros(n, np.float32)
    w = np.ones(n, np.float32)
    for i, line in enumerate(lines):
        label, imp, feats = parse_vw_line(str(line))
        if label is not None:
            y[i] = label
            w[i] = imp
        else:
            # VW treats label-less lines as predict-only examples; zero
            # importance keeps them out of the loss without reindexing
            w[i] = 0.0
        for ns, name, value in feats:
            idx = murmurhash3_32(ns + name, seed) % dim
            x[i, idx] += value
    return x, y, w


class _GenericParams(_OnlineSGDParams):
    inputCol = StringParam(doc="VW-format example column", default="value")
    numBits = IntParam(doc="log2 of hash dimension (VW -b)", default=12)
    lossFunction = StringParam(doc="squared|logistic|hinge|quantile",
                               default="squared",
                               allowed=("squared", "logistic", "hinge",
                                        "quantile"))


class OnlineGeneric(_GenericParams, Estimator):
    """VowpalWabbitGeneric analogue: fit from raw VW text examples."""

    mesh = PyObjectParam(doc="ProcessMesh for data-parallel training "
                             "over a torch.distributed group")

    def _fit(self, ds: Dataset) -> "OnlineGenericModel":
        _check_mesh(self.get("mesh"), self.device)
        x, y, w = vectorize_vw_lines(ds[self.inputCol], int(self.numBits),
                                     int(self.hashSeed))
        loss = str(self.lossFunction)
        if loss in ("logistic", "hinge"):
            y = np.where(y > 0, 1.0, -1.0).astype(np.float32)
        cfg = self._config(loss)
        state, stats = train_sgd(x, y, cfg, sample_weight=w,
                                 init=self.get("initialModel"),
                                 mesh=self.get("mesh"), device=self.device)
        model = OnlineGenericModel(
            inputCol=self.inputCol, numBits=self.numBits,
            hashSeed=self.hashSeed, lossFunction=loss,
            predictionCol=self.predictionCol, device=self.device,
            # a param pickles with the model: keep it off the card
            state=state_to(state, torch.device("cpu")))
        model.training_stats = stats
        return model


class OnlineGenericModel(_GenericParams, Model):
    """Scores raw VW text examples (reference:
    VowpalWabbitGenericModel.transform, VowpalWabbitGeneric.scala:87)."""

    state = PyObjectParam(doc="fitted SGDState")

    def _transform(self, ds: Dataset) -> Dataset:
        x, _, _ = vectorize_vw_lines(ds[self.inputCol], int(self.numBits),
                                     int(self.hashSeed))
        state: SGDState = state_to(self.get("state"),
                                   resolve_device(self.device))
        margin = np.asarray(predict_margin(state, x))
        if str(self.lossFunction) == "logistic":
            out = 1.0 / (1.0 + np.exp(-margin))
        else:
            out = margin
        return ds.with_column(self.predictionCol, out)


class OnlineGenericProgressive(_GenericParams, Transformer):
    """VowpalWabbitGenericProgressive analogue: one-pass learn that emits
    each row's pre-update (progressive validation) prediction."""

    def _transform(self, ds: Dataset) -> Dataset:
        x, y, w = vectorize_vw_lines(ds[self.inputCol], int(self.numBits),
                                     int(self.hashSeed))
        loss = str(self.lossFunction)
        yt = (np.where(y > 0, 1.0, -1.0).astype(np.float32)
              if loss in ("logistic", "hinge") else y)
        import dataclasses
        cfg = self._config(loss)
        one_pass = dataclasses.replace(cfg, num_passes=1)
        bs = max(1, int(self.batchSize))
        preds = np.zeros(len(x), np.float32)
        state: Optional[SGDState] = self.get("initialModel")
        for start in range(0, len(x), bs):
            sl = slice(start, start + bs)
            if state is not None:
                preds[sl] = np.asarray(predict_margin(state, x[sl]))
            state, _ = train_sgd(x[sl], yt[sl], one_pass,
                                 sample_weight=w[sl], init=state,
                                 device=self.device)
        if loss == "logistic":
            preds = 1.0 / (1.0 + np.exp(-preds))
        return ds.with_column(self.predictionCol, preds)
