"""Quantile binning: raw features → small integer bin indices.

The PyTorch port's copy of the JAX package's ``models/gbdt/binning.py``
(:class:`BinMapper`, :func:`fit_bin_mapper`, :class:`FeatureBundler`),
plus :func:`bin_features`, which bins a raw matrix on the training
device, and :func:`bundle_bins`, which bundles a binned matrix there.
Missing values (NaN) get their own bin 0 so split decisions can route
them; the last bin catches +inf.  ``max_bin`` defaults to 255 content
bins + the NaN bin = 256 total.
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


@dataclasses.dataclass
class FeatureBundler:
    """Exclusive feature bundling (EFB) over BINNED features.

    LightGBM's answer to sparse/one-hot data (``enable_bundle``):
    features that are rarely non-default simultaneously merge into one
    bundled column whose bin space concatenates their non-default bins —
    the histogram pass reads O(bundles) columns instead of O(F).

    ``bundle_of[f]`` / ``offset_of[f]`` place original feature ``f``;
    ``owner[b, k]`` inverts a bundled bin back to its original feature so
    split attributions map home.  Default bins (each feature's most common
    bin in the fit sample) collapse to bundled bin 0.
    """
    bundle_of: np.ndarray        # (F,) int32 bundle id per original feature
    offset_of: np.ndarray        # (F,) int32 bin offset inside the bundle
    default_bin: np.ndarray      # (F,) int32 the bin that maps to 0
    num_bins: np.ndarray         # (n_bundles,) int32 total bins per bundle
    owner: list                  # per bundle: (total_bins,) int32 orig feature
    n_features: int

    @property
    def num_bundles(self) -> int:
        return len(self.num_bins)

    @staticmethod
    def fit(binned_sample: np.ndarray, num_bins: np.ndarray,
            max_total_bins: int = 256,
            max_conflict_rate: float = 0.0) -> "FeatureBundler":
        """Greedy conflict-bounded bundling (LightGBM's graph-coloring
        heuristic): features ordered by non-default density each join the
        first bundle whose added conflicts stay within
        ``max_conflict_rate`` of the sample and whose bin budget fits."""
        n, F = binned_sample.shape
        default_bin = np.empty(F, np.int32)
        nondef = np.empty((n, F), bool)
        for f in range(F):
            counts = np.bincount(binned_sample[:, f],
                                 minlength=int(num_bins[f]) + 1)
            default_bin[f] = int(np.argmax(counts))
            nondef[:, f] = binned_sample[:, f] != default_bin[f]
        density = nondef.sum(axis=0)
        order = np.argsort(-density, kind="stable")
        budget = int(max_conflict_rate * n)

        bundle_of = np.full(F, -1, np.int32)
        bundles: list = []          # per bundle: [feature ids]
        bundle_mask: list = []      # per bundle: rows with any non-default
        bundle_bins: list = []      # per bundle: current extra-bin total
        for f in order:
            extra = int(num_bins[f])          # non-default bins of f (+1 slack)
            placed = False
            for bi in range(len(bundles)):
                conflicts = int(np.sum(bundle_mask[bi] & nondef[:, f]))
                if conflicts <= budget and \
                        1 + bundle_bins[bi] + extra <= max_total_bins:
                    bundles[bi].append(int(f))
                    bundle_mask[bi] |= nondef[:, f]
                    bundle_bins[bi] += extra
                    bundle_of[f] = bi
                    placed = True
                    break
            if not placed:
                bundles.append([int(f)])
                bundle_mask.append(nondef[:, f].copy())
                bundle_bins.append(extra)
                bundle_of[f] = len(bundles) - 1

        offset_of = np.zeros(F, np.int32)
        owners = []
        total = np.zeros(len(bundles), np.int32)
        for bi, feats in enumerate(bundles):
            off = 0                            # bundled bin 0 = all-default
            own = [feats[0]]                   # bin 0 owner: first feature
            for f in feats:
                offset_of[f] = off
                own.extend([f] * int(num_bins[f]))
                off += int(num_bins[f])
            total[bi] = off + 1
            owners.append(np.asarray(own, np.int32))
        return FeatureBundler(bundle_of=bundle_of, offset_of=offset_of,
                              default_bin=default_bin, num_bins=total,
                              owner=owners, n_features=F)

    def transform(self, binned: np.ndarray) -> np.ndarray:
        """(n, F) original bins → (n, n_bundles) bundled bins.

        A row's bundled bin is the remapped bin of its LAST-ordered
        non-default feature in the bundle (with max_conflict_rate 0 at most
        one exists; under allowed conflicts this is the deterministic
        tie-break)."""
        n = binned.shape[0]
        out = np.zeros((n, self.num_bundles), binned.dtype
                       if binned.dtype.itemsize >= 2 else np.uint16)
        for f in range(self.n_features):
            bi = self.bundle_of[f]
            col = binned[:, f]
            nd = col != self.default_bin[f]
            # non-default bins rank 1..num_bins in order, skipping default:
            # rank = bin + (bin < default ? 1 : 0) keeps ids dense
            rank = col + np.where(col < self.default_bin[f], 1, 0)
            vals = self.offset_of[f] + rank
            out[nd, bi] = vals[nd].astype(out.dtype)
        return out

    def owner_of_split(self, bundle: int, bundled_bin: int) -> int:
        """Original feature owning a bundled split bin (importance remap)."""
        own = self.owner[bundle]
        return int(own[min(max(bundled_bin, 0), len(own) - 1)])

    def route_tables(self, num_bins: np.ndarray, total_bins: int) -> dict:
        """The arrays that make EFB invisible to the growers (the LightGBM
        scheme: bundling compresses HISTOGRAM construction, but split
        search and the trees stay in ORIGINAL feature space).

        Per original feature ``f`` (all ``(F,)`` int32):
        - ``col``: the bundled column holding f,
        - ``lo``/``hi``: f's bundled-bin range is ``(lo, hi]`` — a row
          outside it has f at its default bin (``lo`` doubles as the rank
          base for thresholds),
        - ``default_bin``: f's default original bin.

        ``gather_src`` ((F, B) int32) maps the ORIGINAL histogram cell
        (f, b) to a flat index into the bundled histogram, with ``-2``
        marking f's default bin (mass = node total − Σ other bins — rows
        whose f is default sit at bundled bin 0 OR inside other features'
        ranges) and ``-1`` marking out-of-range bins (zero).

        An original split (f, b) routes from the bundled column as::

            in_range = (xb > lo[f]) & (xb <= hi[f])
            go_left  = in_range ? xb <= lo[f] + rank(b) : default_bin[f] <= b

        with ``rank(b) = b + (b < default_bin[f])`` (the skip-default rank
        the transform assigns) — monotone in b, so one threshold suffices.
        """
        F = self.n_features
        col = self.bundle_of.astype(np.int32)
        lo = self.offset_of.astype(np.int32)
        hi = (self.offset_of + num_bins[:F].astype(np.int32)).astype(np.int32)
        gather = np.full((F, total_bins), -1, np.int64)
        Bb = total_bins                       # bundled hists share the width
        for f in range(F):
            d = int(self.default_bin[f])
            for b in range(int(num_bins[f]) + 1):
                if b >= total_bins:
                    break
                if b == d:
                    gather[f, b] = -2
                else:
                    rank = b + (1 if b < d else 0)
                    gather[f, b] = int(col[f]) * Bb + int(lo[f]) + rank
        return {"col": col, "lo": lo, "hi": hi,
                "default_bin": self.default_bin.astype(np.int32),
                "gather_src": gather}

    def to_dict(self) -> dict:
        return {"bundle_of": self.bundle_of.tolist(),
                "offset_of": self.offset_of.tolist(),
                "default_bin": self.default_bin.tolist(),
                "num_bins": self.num_bins.tolist(),
                "owner": [o.tolist() for o in self.owner],
                "n_features": self.n_features}

    @staticmethod
    def from_dict(d: dict) -> "FeatureBundler":
        return FeatureBundler(
            bundle_of=np.asarray(d["bundle_of"], np.int32),
            offset_of=np.asarray(d["offset_of"], np.int32),
            default_bin=np.asarray(d["default_bin"], np.int32),
            num_bins=np.asarray(d["num_bins"], np.int32),
            owner=[np.asarray(o, np.int32) for o in d["owner"]],
            n_features=d["n_features"])


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

    The same rule as :meth:`BinMapper.transform`, computed on the device,
    so only the raw float matrix crosses the host link: a numeric column
    takes ``searchsorted(upper_bounds[f], x, side="left")`` capped at
    ``max_bin - 1``, plus one, NaN → :data:`MISSING_BIN`; a categorical
    column looks each value up in its sorted category table and takes
    that category's bin, with unseen categories and NaN in bin 0."""
    x = torch.as_tensor(np.ascontiguousarray(features, np.float32),
                        device=device).t().contiguous()          # (F, n)
    ub = torch.as_tensor(mapper.upper_bounds, device=device).contiguous()
    idx = torch.searchsorted(ub, x, right=False)
    out = torch.clamp_max(idx, mapper.max_bin - 1).to(torch.int32) + 1
    out = torch.where(torch.isnan(x), torch.zeros_like(out), out)
    for j, (vals, bins) in (mapper.cat_features or {}).items():
        if len(vals) == 0:               # all-NaN fit sample: empty table
            out[j] = MISSING_BIN
            continue
        v = torch.as_tensor(np.asarray(vals, np.float32), device=device)
        b = torch.as_tensor(np.asarray(bins, np.int32), device=device)
        at = torch.clamp(torch.searchsorted(v, x[j]), 0, len(vals) - 1)
        out[j] = torch.where(v[at] == x[j], b[at], MISSING_BIN)
    return out


def bundle_bins(bins_t: torch.Tensor, bundler: FeatureBundler) -> torch.Tensor:
    """(F, n) original bins → (n_bundles, n) int32 bundled bins on their
    device: :meth:`FeatureBundler.transform`'s rule, feature by feature in
    the same order, so a later non-default feature of a bundle wins."""
    out = torch.zeros((bundler.num_bundles, bins_t.shape[1]),
                      dtype=torch.int32, device=bins_t.device)
    for f in range(bundler.n_features):
        col = bins_t[f]
        d = int(bundler.default_bin[f])
        rank = col + (col < d).to(torch.int32)
        bi = int(bundler.bundle_of[f])
        out[bi] = torch.where(col != d, int(bundler.offset_of[f]) + rank,
                              out[bi])
    return out
