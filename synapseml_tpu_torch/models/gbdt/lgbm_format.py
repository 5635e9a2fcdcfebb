"""LightGBM text model format: emit + parse.

The PyTorch port's copy of the JAX package's ``models/gbdt/lgbm_format.py``
(numpy, host side), against this package's :class:`~.booster.Booster`,
:class:`~.trainer.Tree` and :class:`~.binning.BinMapper`; the bytes it
writes for a model equal the JAX package's for the same model, and each
package reads the other's files.

- ``tree`` header block: version/num_class/num_tree_per_iteration/
  max_feature_idx/objective/feature_names/feature_infos/average_output.
- Per-tree blocks ``Tree=i``: LightGBM node convention — internal nodes are
  indexed 0..num_leaves-2 and leaves appear as bitwise-complement indices
  (child < 0 ⇒ leaf ~child); splits are ``x <= threshold`` → left with the
  default-left/missing-type flags packed into ``decision_type``.

Export folds per-tree weights (DART normalization; shrinkage is already
applied by training) and the init score (into the first tree of each
class, or into every tree of an averaged RF model) into leaf values, so a
file's predictions equal the model's with no side channel, as LightGBM's
own files behave.  Categorical splits export as bitsets of category
values: the complement set with children swapped, so unseen and missing
categories route as the bin-space split sends bin 0.  Imported models
carry a placeholder bin mapper (raw-threshold prediction never consults
bins) and, for categorical columns, the category tables read back from
``feature_infos``.

Limitations: arbitrary category subsets (a bitset that is not a suffix of
the bin order) and linear-leaf models are rejected; ``leaf_weight``
exports as zeros (the trees keep no per-node hessian sums) while
``leaf_count``/``internal_count`` carry the covers that exact TreeSHAP
reads on both sides of a round trip.
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

from .binning import BinMapper

#: decision_type flags (LightGBM: include/LightGBM/tree.h semantics)
_CATEGORICAL_MASK = 1
_DEFAULT_LEFT_MASK = 2
_MISSING_TYPE_ZERO = 1 << 2
_MISSING_TYPE_NAN = 2 << 2


def _fmt(v: float) -> str:
    return f"{float(v):.17g}"


def _objective_string(objective: str, num_class: int) -> str:
    if objective == "binary":
        return "binary sigmoid:1"
    if objective == "multiclass":
        return f"multiclass num_class:{num_class}"
    if objective == "multiclassova":
        return f"multiclassova num_class:{num_class} sigmoid:1"
    if objective in ("regression", "mse", "l2"):
        return "regression"
    return objective


def _parse_objective(s: str) -> Dict[str, object]:
    parts = s.split()
    name = parts[0] if parts else "regression"
    kv = dict(p.split(":", 1) for p in parts[1:] if ":" in p)
    num_class = int(kv.get("num_class", 1))
    if name == "regression_l2":
        name = "regression"
    return {"objective": name, "num_class": num_class}


# --------------------------------------------------------------------------
# export
# --------------------------------------------------------------------------

def _cat_rightset_bits(vals, bins, split_bin: int):
    """Bitset (uint32 words) of the category VALUES with bin > split_bin —
    our bin-space split sends bin <= t left, so the exported LightGBM
    in-set (which goes left there) is the COMPLEMENT with children
    swapped: unseen/missing categories then fall through LightGBM's
    not-in-set branch onto our left child, matching bin 0 <= t exactly."""
    right_vals = [int(v) for v, b in zip(vals, bins) if int(b) > split_bin]
    n_words = (max(right_vals) // 32 + 1) if right_vals else 1
    words = [0] * n_words
    for v in right_vals:
        words[v // 32] |= 1 << (v % 32)
    return words


def _tree_block(tree, weight: float, bias: float, index: int,
                shrinkage: float, cat_features: Dict = None) -> str:
    """One ``Tree=i`` section in LightGBM node numbering."""
    n_nodes = int(tree.num_nodes)
    lc = np.asarray(tree.left_child[:n_nodes])
    rc = np.asarray(tree.right_child[:n_nodes])
    internal = np.nonzero(lc >= 0)[0]
    leaves = np.nonzero(lc < 0)[0]
    int_idx = {int(n): i for i, n in enumerate(internal)}
    leaf_idx = {int(n): i for i, n in enumerate(leaves)}
    cat_features = cat_features or {}

    def child(c: int) -> int:
        c = int(c)
        return int_idx[c] if int(lc[c]) >= 0 else ~leaf_idx[c]

    # categorical nodes: bitset per node, children swapped (see
    # _cat_rightset_bits); cat_idx indexes cat_boundaries in node order
    is_cat = [int(tree.split_feature[n]) in cat_features for n in internal]
    cat_boundaries = [0]
    cat_words: List[int] = []
    cat_idx_of = {}
    for n, c in zip(internal, is_cat):
        if c:
            f = int(tree.split_feature[n])
            vals, bins = cat_features[f]
            words = _cat_rightset_bits(vals, bins,
                                       int(tree.split_bin[n]))
            cat_idx_of[int(n)] = len(cat_boundaries) - 1
            cat_words.extend(words)
            cat_boundaries.append(len(cat_words))

    lines = [f"Tree={index}",
             f"num_leaves={len(leaves)}",
             f"num_cat={len(cat_boundaries) - 1}"]
    leaf_vals = [float(tree.node_value[n]) * weight + bias for n in leaves]
    if len(internal):
        dl = np.asarray(tree.default_left[:n_nodes])
        mz = np.asarray(tree.missing_zero[:n_nodes])

        def dtype_of(n, cat):
            if cat:
                return _CATEGORICAL_MASK
            missing = _MISSING_TYPE_ZERO if mz[n] else _MISSING_TYPE_NAN
            return (_DEFAULT_LEFT_MASK if dl[n] else 0) | missing

        def thr_of(n, cat):
            return str(cat_idx_of[int(n)]) if cat \
                else _fmt(tree.threshold[n])

        lines += [
            "split_feature=" + " ".join(str(int(tree.split_feature[n]))
                                        for n in internal),
            "split_gain=" + " ".join(_fmt(tree.split_gain[n])
                                     for n in internal),
            "threshold=" + " ".join(thr_of(n, c)
                                    for n, c in zip(internal, is_cat)),
            "decision_type=" + " ".join(str(dtype_of(n, c))
                                        for n, c in zip(internal, is_cat)),
            # categorical children SWAP: the file's in-set-left is our
            # right child
            "left_child=" + " ".join(
                str(child(rc[n] if c else lc[n]))
                for n, c in zip(internal, is_cat)),
            "right_child=" + " ".join(
                str(child(lc[n] if c else rc[n]))
                for n, c in zip(internal, is_cat)),
        ]
        if len(cat_boundaries) > 1:
            lines += [
                "cat_boundaries=" + " ".join(str(b) for b in cat_boundaries),
                "cat_threshold=" + " ".join(str(w) for w in cat_words),
            ]
    counts = np.asarray(tree.node_count[:n_nodes])
    lines += [
        "leaf_value=" + " ".join(_fmt(v) for v in leaf_vals),
        "leaf_weight=" + " ".join("0" for _ in leaves),
        "leaf_count=" + " ".join(str(int(counts[n])) for n in leaves),
    ]
    if len(internal):
        lines += [
            "internal_value=" + " ".join(
                _fmt(float(tree.node_value[n]) * weight + bias)
                for n in internal),
            "internal_weight=" + " ".join("0" for _ in internal),
            "internal_count=" + " ".join(str(int(counts[n]))
                                         for n in internal),
        ]
    lines += ["is_linear=0", f"shrinkage={_fmt(shrinkage)}"]
    return "\n".join(lines) + "\n"


def booster_to_lgbm_string(booster) -> str:
    """Serialize a Booster to LightGBM's text model format."""
    K = booster.num_class
    F = booster.bin_mapper.num_features
    is_rf = booster.config.boosting_type == "rf"
    cat_features = booster.bin_mapper.cat_features or {}
    for f, (vals, _bins) in cat_features.items():
        bad = [v for v in vals
               if not float(v).is_integer() or v < 0 or v >= 1 << 21]
        if bad:
            raise ValueError(
                f"categorical feature {f}: LightGBM bitset thresholds "
                f"need non-negative integer categories < 2^21; got "
                f"{bad[:3]}")
    blocks: List[str] = []
    seen_class: Dict[int, bool] = {}
    for i, tree in enumerate(booster.trees):
        k = booster.tree_class[i]
        w = float(booster.tree_weights[i])
        # init score folds into leaf values: once per class for summed
        # models, into EVERY tree for averaged (rf) models so that
        # mean(leaves) keeps the full bias
        if is_rf:
            bias = float(booster.init_score[min(k, len(booster.init_score) - 1)])
        else:
            bias = 0.0
            if not seen_class.get(k):
                seen_class[k] = True
                bias = float(
                    booster.init_score[min(k, len(booster.init_score) - 1)])
        blocks.append(_tree_block(tree, w, bias, i,
                                  booster.config.learning_rate,
                                  cat_features))

    def feat_info(f: int) -> str:
        if f not in cat_features:
            return "[-1e+308:1e+308]"
        # categorical feature_infos: category values in BIN order (the
        # target-statistic order bins were assigned in) — LightGBM's own
        # categorical feature_infos form, and what lets an import rebuild
        # the bin-space LUT exactly.  An empty LUT (all-NaN fit column)
        # emits LightGBM's "none" token — an empty string would collapse
        # under whitespace split and misalign every later feature
        vals, bins = cat_features[f]
        if len(vals) == 0:
            return "none"
        by_bin = sorted(zip(bins, vals))
        return ":".join(str(int(v)) for _, v in by_bin)

    header = ["tree", "version=v3",
              f"num_class={K}",
              f"num_tree_per_iteration={K}",
              "label_index=0",
              f"max_feature_idx={F - 1}",
              "objective=" + _objective_string(booster.objective, K),
              "feature_names=" + " ".join(booster.feature_names),
              "feature_infos=" + " ".join(feat_info(f) for f in range(F))]
    if booster.config.boosting_type == "rf":
        header.append("average_output")
    body = "\n\n".join(blocks)
    header.append("tree_sizes=" + " ".join(str(len(b) + 1) for b in blocks))
    out = "\n".join(header) + "\n\n" + body + "\nend of trees\n"
    mono = booster.config.monotone_constraints
    if mono and any(mono):
        # LightGBM-style parameters section so constrained models survive
        # the round trip (LightGBM emits the full config here; we carry
        # the monotone settings, the ones that change predict semantics)
        out += ("\nparameters:\n"
                "[monotone_constraints: "
                + ",".join(str(int(c)) for c in mono) + "]\n"
                "[monotone_constraints_method: "
                + booster.config.monotone_constraints_method + "]\n"
                f"[monotone_penalty: {booster.config.monotone_penalty}]\n"
                "end of parameters\n")
    return out


# --------------------------------------------------------------------------
# import
# --------------------------------------------------------------------------

def _parse_block(text: str) -> Dict[str, str]:
    out = {}
    for line in text.splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def _bitset_values(words: List[int]) -> set:
    out = set()
    for wi, w in enumerate(words):
        w = int(w) & 0xffffffff
        while w:
            b = (w & -w).bit_length() - 1
            out.add(wi * 32 + b)
            w &= w - 1
    return out


def _tree_from_block(fields: Dict[str, str], max_leaves: int,
                     cat_luts: Dict = None):
    from .trainer import Tree

    n_leaves = int(fields["num_leaves"])
    num_cat = int(fields.get("num_cat", "0") or 0)
    if num_cat > 0 and not cat_luts:
        raise ValueError(
            "categorical splits (num_cat>0) need categorical "
            "feature_infos (colon-separated category lists) to rebuild "
            "the bin-space LUT")
    if fields.get("is_linear", "0").strip() == "1":
        raise ValueError("linear-leaf trees (is_linear=1) are not supported")
    n_int = max(n_leaves - 1, 0)
    M = 2 * max_leaves
    split_feature = np.full(M, -1, np.int32)
    threshold = np.zeros(M, np.float32)
    split_gain = np.zeros(M, np.float32)
    left = np.full(M, -1, np.int32)
    right = np.full(M, -1, np.int32)
    node_value = np.zeros(M, np.float32)
    leaf_value = np.zeros(M, np.float32)
    default_left = np.ones(M, bool)
    node_count = np.zeros(M, np.float32)
    missing_zero = np.zeros(M, bool)

    def arr(key, dtype, n, default=None):
        if key not in fields:
            if default is not None:
                return np.full(n, default, dtype)
            raise ValueError(f"model string missing '{key}'")
        vals = fields[key].split()
        if len(vals) != n:
            raise ValueError(f"'{key}' has {len(vals)} values, expected {n}")
        return np.asarray([dtype(v) for v in vals])

    split_bin = np.zeros(M, np.int32)
    lv = arr("leaf_value", float, n_leaves)
    lcnt = arr("leaf_count", float, n_leaves, default=0.0)
    icnt = arr("internal_count", float, n_int, default=0.0)
    if n_int:
        sf = arr("split_feature", int, n_int)
        th = arr("threshold", float, n_int)
        sg = arr("split_gain", float, n_int, default=0.0)
        lc = arr("left_child", int, n_int)
        rc = arr("right_child", int, n_int)
        iv = arr("internal_value", float, n_int, default=0.0)
        dt = np.asarray(arr("decision_type", int, n_int,
                            default=_DEFAULT_LEFT_MASK | _MISSING_TYPE_NAN))
        cat_nodes = (dt & _CATEGORICAL_MASK) != 0
        if np.any(cat_nodes):
            bounds = [int(v) for v in fields["cat_boundaries"].split()]
            words = [int(v) for v in fields["cat_threshold"].split()]
            for j in np.nonzero(cat_nodes)[0]:
                f = int(sf[j])
                if f not in (cat_luts or {}):
                    raise ValueError(
                        f"categorical split on feature {f} but its "
                        "feature_infos entry is not a category list")
                vals, bins = cat_luts[f]
                ci = int(th[j])
                in_set = _bitset_values(words[bounds[ci]:bounds[ci + 1]])
                # the file's in-set goes to ITS left; our convention is
                # bin <= t left with children swapped at export — so the
                # in-set must be a bin SUFFIX, t = min(in-set bins) - 1
                set_bins = sorted(int(b) for v, b in zip(vals, bins)
                                  if int(v) in in_set)
                nb = int(np.max(bins)) if len(bins) else 0
                if set_bins and (set_bins[0] + len(set_bins) - 1
                                 != set_bins[-1]
                                 or set_bins[-1] != nb):
                    raise ValueError(
                        "categorical bitset is not a contiguous suffix of "
                        "the target-ordered bins: arbitrary category "
                        "subsets (foreign LightGBM files) are not "
                        "representable in bin space — retrain here")
                t = (set_bins[0] - 1) if set_bins else nb
                split_bin[j] = t
                # swap children back: file-left (in-set) is our right
                lc[j], rc[j] = rc[j], lc[j]
                th[j] = float(t)       # hybrid traversal compares bins
        # missing_type bits 2-3: 0=None, 1=Zero, 2=NaN.  NaN missing (the
        # LightGBM float default) keeps the stored default direction.  For
        # None, LightGBM coerces NaN input to 0.0 — emulated exactly by
        # routing NaN where 0.0 would compare.  Zero missing (0.0 itself
        # treated as missing, |x| <= kZeroThreshold) rides the per-node
        # ``missing_zero`` flag on Tree.
        mtype = (dt >> 2) & 3

        def map_child(c: int) -> int:
            return int(c) if c >= 0 else n_int + (~int(c))

        for j in range(n_int):
            split_feature[j] = sf[j]
            threshold[j] = th[j]
            split_gain[j] = sg[j]
            left[j] = map_child(lc[j])
            right[j] = map_child(rc[j])
            node_value[j] = iv[j]
            node_count[j] = icnt[j]
            if ((dt[j] >> 2) & 3) == 0:          # None: NaN behaves as 0.0
                default_left[j] = bool(0.0 <= th[j])
            else:
                default_left[j] = bool(dt[j] & _DEFAULT_LEFT_MASK)
                missing_zero[j] = mtype[j] == 1
    for l in range(n_leaves):
        node_value[n_int + l] = lv[l]
        leaf_value[n_int + l] = lv[l]
        node_count[n_int + l] = lcnt[l]
    return Tree(split_feature=split_feature,
                split_bin=split_bin,
                threshold=threshold.astype(np.float32),
                split_gain=split_gain.astype(np.float32),
                left_child=left, right_child=right,
                leaf_value=leaf_value, node_value=node_value,
                num_nodes=np.asarray(n_int + n_leaves, np.int32),
                default_left=default_left,
                node_count=node_count,
                missing_zero=missing_zero)


def booster_from_lgbm_string(s: str, device="cuda"):
    """Parse a LightGBM text model into a Booster predicting on
    ``device``."""
    from .booster import Booster, BoostingConfig

    head, _, tail = s.partition("Tree=")
    if not tail:
        raise ValueError("not a LightGBM model string: no 'Tree=' block")
    header = _parse_block(head)
    obj = _parse_objective(header.get("objective", "regression"))
    K = max(int(header.get("num_tree_per_iteration", obj["num_class"])), 1)
    F = int(header.get("max_feature_idx", "0")) + 1
    feature_names = header.get("feature_names", "").split() or \
        [f"f{i}" for i in range(F)]
    is_rf = bool(re.search(r"^average_output\s*$", head, re.MULTILINE))

    # categorical feature_infos (colon-separated category values, in bin
    # order) rebuild the bin-space LUTs our categorical splits route by
    cat_luts: Dict[int, tuple] = {}
    infos = header.get("feature_infos", "").split()
    for f, info in enumerate(infos[:F]):
        # numerical infos are bracketed ranges; anything unbracketed (bar
        # LightGBM's "none") is a category list — a SINGLE category has no
        # colon yet must still rebuild its LUT
        if info and not info.startswith("[") and info != "none":
            vals_in_bin_order = [float(v) for v in info.split(":") if v]
            order = np.argsort(vals_in_bin_order, kind="stable")
            vals_sorted = np.asarray(vals_in_bin_order, np.float64)[order]
            bins_sorted = (np.asarray(order, np.int64) + 1).astype(np.int32)
            cat_luts[f] = (vals_sorted, bins_sorted)

    tree_texts = ("Tree=" + tail).split("end of trees")[0]
    blocks = [b for b in re.split(r"\n(?=Tree=\d)", tree_texts) if b.strip()]
    parsed = [_parse_block(b) for b in blocks]
    max_leaves = max(int(p["num_leaves"]) for p in parsed)
    trees = [_tree_from_block(p, max_leaves, cat_luts) for p in parsed]

    objective = str(obj["objective"])
    mkw = {}
    mtc = re.search(r"\[monotone_constraints:\s*([^\]]*)\]", s)
    if mtc and mtc.group(1).strip():
        vals = [int(v) for v in re.split(r"[,\s]+", mtc.group(1).strip())
                if v]
        if any(vals):
            mkw["monotone_constraints"] = vals
    mmeth = re.search(r"\[monotone_constraints_method:\s*([^\]]*)\]", s)
    if mmeth and mmeth.group(1).strip():
        mkw["monotone_constraints_method"] = mmeth.group(1).strip()
    mpen = re.search(r"\[monotone_penalty:\s*([^\]]*)\]", s)
    if mpen:
        try:
            mkw["monotone_penalty"] = float(mpen.group(1))
        except ValueError:
            pass
    cfg = BoostingConfig(objective=objective,
                         boosting_type="rf" if is_rf else "gbdt",
                         num_class=K if K > 1 else 1,
                         num_leaves=max(max_leaves, 2), **mkw)
    mapper = BinMapper(upper_bounds=np.full((F, 255), np.inf, np.float32),
                       num_bins=np.ones(F, np.int32), max_bin=255,
                       cat_features=cat_luts or None)
    return Booster(trees=trees,
                   tree_class=[i % K for i in range(len(trees))],
                   tree_weights=[1.0] * len(trees),
                   num_class=K if K > 1 else 1,
                   objective=objective,
                   init_score=np.zeros(max(K, 1), np.float32),
                   bin_mapper=mapper,
                   feature_names=feature_names[:F],
                   config=cfg, device=device)
