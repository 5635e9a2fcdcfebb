"""OpenAI-style completion/embedding/prompt stages (reference:
cognitive/.../openai/OpenAI.scala:246 OpenAICompletion/OpenAIEmbedding,
openai/OpenAIPrompt.scala:172 — prompt templating over dataset columns).

Endpoints are plain URLs; with a local inference server (e.g. the port's
LLM behind :mod:`synapseml_tpu_torch.serving`) these stages chain
generation into pipelines exactly like the reference does against Azure
OpenAI.  The PyTorch port's copy of the JAX package's
``services/openai.py``."""

from __future__ import annotations

import json
from typing import Any, Dict

from ..core.params import DictParam, FloatParam, IntParam, StringParam
from ..io.http import HTTPRequestData
from ..core.utils import interpolate_template
from .base import RemoteServiceTransformer


class OpenAICompletion(RemoteServiceTransformer):
    """Text completion per row (reference: OpenAI.scala OpenAICompletion)."""

    promptCol = StringParam(doc="prompt column", default="prompt")
    maxTokens = IntParam(doc="max_tokens", default=128)
    temperature = FloatParam(doc="sampling temperature", default=0.0)
    model = StringParam(doc="model name", default="")
    extraBody = DictParam(doc="extra request-body fields", default=None)

    def prepare_request(self, row: Dict[str, Any]) -> HTTPRequestData:
        body = {"prompt": str(row[self.promptCol]),
                "max_tokens": int(self.maxTokens),
                "temperature": float(self.temperature)}
        if self.model:
            body["model"] = self.model
        body.update(self.get("extraBody") or {})
        return HTTPRequestData(url=self.url, method="POST",
                               headers={"Content-Type": "application/json"},
                               entity=json.dumps(body).encode())

    def parse_response(self, value: Any) -> Any:
        if isinstance(value, dict) and "choices" in value:
            choices = value["choices"]
            if choices:
                c = choices[0]
                return c.get("text", c.get("message", {}).get("content"))
        return value


class OpenAIEmbedding(RemoteServiceTransformer):
    """Embedding per row (reference: OpenAI.scala OpenAIEmbedding)."""

    textCol = StringParam(doc="text column", default="text")
    model = StringParam(doc="model name", default="")

    def prepare_request(self, row: Dict[str, Any]) -> HTTPRequestData:
        body = {"input": str(row[self.textCol])}
        if self.model:
            body["model"] = self.model
        return HTTPRequestData(url=self.url, method="POST",
                               headers={"Content-Type": "application/json"},
                               entity=json.dumps(body).encode())

    def parse_response(self, value: Any) -> Any:
        if isinstance(value, dict) and "data" in value:
            data = value["data"]
            if data and "embedding" in data[0]:
                import numpy as np
                return np.asarray(data[0]["embedding"], np.float32)
        return value




class OpenAIPrompt(OpenAICompletion):
    """Column-templated prompting (reference: OpenAIPrompt.scala:172):
    ``promptTemplate`` like ``"classify: {text} -> "`` interpolates
    dataset columns per row before completion."""

    promptTemplate = StringParam(doc="template with {column} placeholders")
    postProcessing = StringParam(doc="none | csv | json", default="none")

    def prepare_request(self, row: Dict[str, Any]) -> HTTPRequestData:
        template = self.promptTemplate
        if not template:
            raise ValueError("promptTemplate is required")
        prompt = interpolate_template(template, row.get)
        return super().prepare_request({**row, self.promptCol: prompt})

    def parse_response(self, value: Any) -> Any:
        text = super().parse_response(value)
        mode = self.postProcessing
        if not isinstance(text, str) or mode == "none":
            return text
        if mode == "csv":
            return [t.strip() for t in text.split(",") if t.strip()]
        if mode == "json":
            try:
                return json.loads(text)
            except ValueError:
                return None
        return text
