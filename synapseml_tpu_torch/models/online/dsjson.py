"""Decision-Service JSON ingestion for bandit logs.

The PyTorch port's copy of the JAX package's ``models/online/dsjson.py``.

Counterpart of the reference's VowpalWabbitDSJsonTransformer
(reference: vw/.../VowpalWabbitDSJsonTransformer.scala:20-108): each row of
``dsJsonColumn`` holds one ds-json event; the transform extracts the
header fields into columns named exactly as the reference does —
``EventId``, ``rewards`` (a dict keyed by the ``rewards`` param aliases),
``probLog`` (``_label_probability``) and ``chosenActionIndex``
(``_labelIndex``) — ready for the policy-evaluation stages.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

from ...core.dataset import Dataset
from ...core.params import DictParam, StringParam
from ...core.pipeline import Transformer

EVENT_ID_COL = "EventId"
REWARDS_COL = "rewards"
PROB_LOGGED_COL = "probLog"
CHOSEN_ACTION_INDEX_COL = "chosenActionIndex"


def _reward_value(raw) -> float:
    """Missing or malformed reward fields become NaN (the reference emits
    Spark nulls); one corrupt event must not abort the whole batch."""
    if raw is None:
        return float("nan")
    try:
        return float(raw)
    except (TypeError, ValueError):
        return float("nan")


class DSJsonTransformer(Transformer):
    """Parse ds-json bandit events into typed columns."""

    dsJsonColumn = StringParam(doc="column containing ds-json",
                               default="value")
    rewards = DictParam(doc="output alias → ds-json field to extract as a "
                            "reward", default={"reward": "_label_cost"})

    def _transform(self, ds: Dataset) -> Dataset:
        rewards: Dict[str, str] = dict(self.rewards)
        n = ds.num_rows
        event_ids = np.empty(n, object)
        reward_rows = np.empty(n, object)
        prob = np.full(n, np.nan, np.float32)
        # -1 = missing (the reference emits Spark nulls for absent fields;
        # 0 is a valid action index so it cannot double as the sentinel)
        chosen = np.full(n, -1, np.int32)
        for i, raw in enumerate(ds[self.dsJsonColumn]):
            obj = json.loads(str(raw))
            event_ids[i] = obj.get(EVENT_ID_COL)
            reward_rows[i] = {alias: _reward_value(obj.get(field))
                              for alias, field in rewards.items()}
            p = obj.get("_label_probability")
            if p is not None:
                prob[i] = float(p)
            idx = obj.get("_labelIndex")
            if idx is not None:
                chosen[i] = int(idx)
        return ds.with_columns({
            EVENT_ID_COL: event_ids,
            REWARDS_COL: reward_rows,
            PROB_LOGGED_COL: prob,
            CHOSEN_ACTION_INDEX_COL: chosen,
        })
