"""LLMTransformer: a local text-completion pipeline stage.

The PyTorch port of the JAX package's ``models/llm/stage.py``: a prompt
column in, a completion column out, with a ``promptTemplate`` for
``{column}`` interpolation, over the port's :func:`~.generate.generate`
on the model's device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ...core.dataset import Dataset
from ...core.params import FloatParam, IntParam, PyObjectParam, StringParam
from ...core.pipeline import Transformer
from ...core.utils import interpolate_template
from .generate import generate


class LLMTransformer(Transformer):
    """Generate completions for a prompt column with a local LLM.

    ``bundle`` carries ``{"model": LlamaModel, "tokenizer": a tokenizer
    with encode/decode}`` (the port's model holds its parameters, so the
    reference's ``"variables"`` entry is not needed).  Rows are grouped by
    prompt token length, so every :func:`generate` call sees equal-length
    prompts."""

    inputCol = StringParam(doc="prompt column", default="prompt")
    outputCol = StringParam(doc="completion output column",
                            default="completion")
    promptTemplate = StringParam(
        doc="optional template with {column} slots (OpenAIPrompt analogue)",
        default=None)
    maxNewTokens = IntParam(doc="tokens to generate", default=32)
    temperature = FloatParam(doc="0 = greedy", default=0.0)
    topK = IntParam(doc="top-k sampling cutoff (0 = off)", default=0)
    topP = FloatParam(doc="nucleus sampling mass (1 = off)", default=1.0)
    seed = IntParam(doc="sampling seed", default=0)
    bundle = PyObjectParam(doc="{model, tokenizer}")

    def _prompts(self, ds: Dataset) -> List[str]:
        template = self.get("promptTemplate")
        if not template:
            return [str(p) for p in ds[self.inputCol]]
        # unknown slots and literal braces pass through unchanged
        return [interpolate_template(
                    template, lambda c, i=i: ds[c][i] if c in ds else None)
                for i in range(ds.num_rows)]

    def _transform(self, ds: Dataset) -> Dataset:
        b: Dict[str, Any] = self.get("bundle")
        model, tok = b["model"], b["tokenizer"]
        prompts = self._prompts(ds)
        # leave room in the context window for the generated continuation
        budget = model.cfg.max_len - int(self.maxNewTokens)
        if budget < 4:
            raise ValueError(
                f"maxNewTokens={int(self.maxNewTokens)} leaves fewer than 4 "
                f"prompt tokens of the model's max_len={model.cfg.max_len} "
                "context window; lower maxNewTokens or use a longer-context "
                "model")
        enc = [[t for t in row if t]            # strip padding
               for row in tok.encode(prompts, budget)[0]]
        # an empty prompt starts from one pad token (id 0)
        enc = [ids if ids else [0] for ids in enc]
        out: List[Optional[str]] = [None] * len(prompts)
        by_len: Dict[int, List[int]] = {}
        for i, ids in enumerate(enc):
            by_len.setdefault(len(ids), []).append(i)
        for _, idxs in sorted(by_len.items()):
            batch = np.asarray([enc[i] for i in idxs], np.int32)
            toks = generate(model, batch, max_new_tokens=self.maxNewTokens,
                            temperature=self.temperature, top_k=self.topK,
                            top_p=self.topP, seed=self.seed)
            for i, text in zip(idxs, tok.decode(toks)):
                out[i] = text
        return ds.with_column(self.outputCol, out)
