"""Quantile binning: raw features → small integer bin indices.

The PyTorch port's copy of the JAX package's ``models/gbdt/binning.py``
(:class:`BinMapper`, :func:`fit_bin_mapper`), plus :func:`bin_features`,
which bins a raw matrix on the training device.  Missing values (NaN) get
their own bin 0 so split decisions can route them; the last bin catches
+inf.  ``max_bin`` defaults to 255 content bins + the NaN bin = 256
total.  Exclusive feature bundling (``FeatureBundler``) is not part of
this slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

MISSING_BIN = 0  # NaN bucket; content bins are 1..max_bin


@dataclasses.dataclass
class BinMapper:
    """Per-feature quantile bin boundaries.

    ``upper_bounds[f, b]`` is the inclusive upper raw-value bound of content
    bin ``b+1``; shape (num_features, max_bin).  Unused trailing bins repeat
    +inf.  ``num_bins[f]`` counts distinct content bins for feature f.
    """
    upper_bounds: np.ndarray          # (F, max_bin) float32
    num_bins: np.ndarray              # (F,) int32
    max_bin: int
    #: categorical features: {feature index: (sorted raw values, bin ids)}
    #: — bin ids are target-statistic ordered (LightGBM's sorted-by-G/H
    #: idea applied at binning time), so range splits in bin space act as
    #: category-subset splits; unseen categories land in bin 0
    cat_features: Optional[dict] = None

    @property
    def num_features(self) -> int:
        return self.upper_bounds.shape[0]

    @property
    def total_bins(self) -> int:      # content bins + missing bin
        return self.max_bin + 1

    @property
    def has_categorical(self) -> bool:
        return bool(self.cat_features)

    def transform(self, features: np.ndarray) -> np.ndarray:
        """Map raw (n, F) floats → (n, F) int32 bins ∈ [0, max_bin].

        Accepts any float dtype (the bf16 colstore's streamed chunks
        arrive as exact f32 upcasts of bf16-rounded values — see
        ``io.colstore.write_matrix(dtype="bf16")``: boundaries are
        quantiles, so bf16-rounding the values moves a row across a
        boundary only when it was within one rounding ulp of it)."""
        features = np.asarray(features, np.float32)
        n, f = features.shape
        out = np.empty((n, f), np.int32)
        cat = self.cat_features or {}
        for j in range(f):
            col = features[:, j]
            if j in cat:
                vals, bins = cat[j]
                if len(vals) == 0:       # all-NaN fit sample: empty LUT
                    out[:, j] = MISSING_BIN
                    continue
                idx = np.searchsorted(vals, col)
                idx_c = np.minimum(idx, len(vals) - 1)
                hit = vals[idx_c] == col
                out[:, j] = np.where(hit, bins[idx_c], MISSING_BIN)
                continue
            # searchsorted over this feature's bounds; bin ids are 1-based
            idx = np.searchsorted(self.upper_bounds[j], col, side="left")
            out[:, j] = np.minimum(idx, self.max_bin - 1) + 1
            out[np.isnan(col), j] = MISSING_BIN
        return out

    def bin_threshold_value(self, feature: int, bin_id: int) -> float:
        """Raw-value threshold for 'bin <= bin_id' splits (for raw predict)."""
        return float(self.upper_bounds[feature, max(bin_id - 1, 0)])


def fit_bin_mapper(features: np.ndarray, max_bin: int = 255,
                   sample_count: int = 200_000,
                   seed: int = 0,
                   categorical_features=None,
                   y: Optional[np.ndarray] = None) -> BinMapper:
    """Compute quantile bin boundaries from a row sample.

    Mirrors the reference's sampled dataset creation
    (LGBM_DatasetCreateFromSampledColumn, StreamingPartitionTask.scala:374):
    sample rows, per-feature quantiles as boundaries, dedup to distinct
    values when a feature has few uniques.

    ``categorical_features``: feature indexes treated as category codes
    (the reference's categoricalSlotIndexes param,
    params/LightGBMParams.scala).  Their bins are ordered by the mean of
    ``y`` per category when labels are provided — the sorted-by-target-
    statistic trick that lets monotone bin-range splits act like
    LightGBM's category-subset splits — else by value; categories beyond
    ``max_bin`` (rarest first) and unseen ones fall into bin 0.
    """
    n, f = features.shape
    if n > sample_count:
        rng = np.random.default_rng(seed)
        pick = rng.choice(n, sample_count, replace=False)
        sample = features[pick]
        y_sample = None if y is None else np.asarray(y)[pick]
    else:
        sample = features
        y_sample = None if y is None else np.asarray(y)
    upper = np.full((f, max_bin), np.inf, np.float32)
    nbins = np.zeros(f, np.int32)
    cat_set = set(int(c) for c in (categorical_features or []))
    cat_out: dict = {}
    for j in range(f):
        col = sample[:, j]
        if j in cat_set:
            valid = ~np.isnan(col)
            vals, inv, counts = np.unique(col[valid], return_inverse=True,
                                          return_counts=True)
            if len(vals) > max_bin:      # keep the most frequent max_bin
                keep = np.sort(np.argsort(-counts)[:max_bin])
                remap = np.full(len(vals), -1)
                remap[keep] = np.arange(len(keep))
                mask = remap[inv] >= 0
                vals, inv, counts = (vals[keep],
                                     remap[inv][mask],
                                     counts[keep])
                yv = (y_sample[valid][mask]
                      if y_sample is not None else None)
            else:
                yv = y_sample[valid] if y_sample is not None else None
            if yv is not None and len(vals):
                sums = np.bincount(inv, weights=yv, minlength=len(vals))
                order = np.argsort(sums / np.maximum(counts, 1),
                                   kind="stable")
            else:
                order = np.arange(len(vals))
            bins = np.empty(len(vals), np.int32)
            bins[order] = np.arange(1, len(vals) + 1)
            cat_out[j] = (vals.astype(np.float32), bins)
            nbins[j] = len(vals)
            continue
        col = col[~np.isnan(col)]
        if col.size == 0:
            nbins[j] = 1
            continue
        uniq = np.unique(col)
        if len(uniq) <= max_bin:
            # one bin per distinct value; boundary midway to the next value
            bounds = (uniq[:-1] + uniq[1:]) / 2 if len(uniq) > 1 else np.array([], np.float64)
            k = len(bounds)
            upper[j, :k] = bounds
            nbins[j] = k + 1
        else:
            qs = np.quantile(col, np.linspace(0, 1, max_bin + 1)[1:-1])
            bounds = np.unique(qs.astype(np.float32))
            k = len(bounds)
            upper[j, :k] = bounds
            nbins[j] = k + 1
    return BinMapper(upper_bounds=upper, num_bins=nbins, max_bin=max_bin,
                     cat_features=cat_out or None)


def bin_features(features: np.ndarray, mapper: BinMapper,
                 device: torch.device) -> torch.Tensor:
    """Raw (n, F) float32 features → (F, n) int32 bins on ``device``.

    Numeric features only.  The same rule as :meth:`BinMapper.transform`
    — ``searchsorted(upper_bounds[f], x, side="left")`` capped at
    ``max_bin - 1``, plus one, NaN → :data:`MISSING_BIN` — computed on the
    device, so only the raw float matrix crosses the host link."""
    if mapper.has_categorical:
        raise NotImplementedError(
            "categorical features are not ported yet (ROADMAP queue A, "
            "GBDT breadth)")
    x = torch.as_tensor(np.ascontiguousarray(features, np.float32),
                        device=device).t().contiguous()          # (F, n)
    ub = torch.as_tensor(mapper.upper_bounds, device=device).contiguous()
    idx = torch.searchsorted(ub, x, right=False)
    out = torch.clamp_max(idx, mapper.max_bin - 1).to(torch.int32) + 1
    return torch.where(torch.isnan(x), torch.zeros_like(out), out)
