"""Text-analytics service stages (reference: cognitive/.../text/
TextAnalytics.scala — TextSentiment, KeyPhraseExtractor families: batch
documents into {documents: [{id, text, language}]} requests, unpack the
per-document results).

The PyTorch port's copy of the JAX package's ``services/text.py``.
"""

from __future__ import annotations

import json
from typing import Any, Dict

from ..io.http import HTTPRequestData
from .base import RemoteServiceTransformer, ServiceParam
from ..core.params import ListParam, StringParam


class _TextServiceBase(RemoteServiceTransformer):
    textCol = StringParam(doc="input text column", default="text")
    language = ServiceParam(doc="document language (value or column)")

    def prepare_request(self, row: Dict[str, Any]) -> HTTPRequestData:
        doc = {"id": "0", "text": str(row[self.textCol])}
        lang = self.resolve_service_param("language", row)
        if lang:
            doc["language"] = lang
        body = json.dumps({"documents": [doc]}).encode()
        return HTTPRequestData(url=self.url, method="POST",
                               headers={"Content-Type": "application/json"},
                               entity=body)

    def parse_response(self, value: Any) -> Any:
        if isinstance(value, dict) and "documents" in value:
            docs = value["documents"]
            return docs[0] if docs else None
        return value


class TextSentiment(_TextServiceBase):
    """Sentiment per row (reference: TextAnalytics.scala TextSentiment)."""


class KeyPhraseExtractor(_TextServiceBase):
    """Key phrases per row (reference: TextAnalytics.scala
    KeyPhraseExtractor)."""


class LanguageDetector(_TextServiceBase):
    """Language detection per row (reference: TextAnalytics.scala
    LanguageDetector — the base omits the language hint when unset)."""


class EntityDetector(_TextServiceBase):
    """Linked-entity detection (reference: TextAnalytics.scala
    EntityDetector)."""


class NER(_TextServiceBase):
    """Named-entity recognition (reference: TextAnalytics.scala NER)."""


class PII(_TextServiceBase):
    """PII redaction (reference: TextAnalytics.scala PII — response also
    carries ``redactedText`` per document)."""


class AnalyzeHealthText(_TextServiceBase):
    """Healthcare entity extraction (reference: TextAnalytics.scala
    AnalyzeHealthText)."""


class TextAnalyze(_TextServiceBase):
    """Multi-task text analysis (reference: TextAnalytics.scala
    TextAnalyze — bundles several analyses in one request; ``tasks``
    lists the analysis kinds to run)."""

    tasks = ListParam(doc="analysis task names", default=None)

    def prepare_request(self, row: Dict[str, Any]) -> HTTPRequestData:
        req = super().prepare_request(row)
        body = json.loads(req.entity.decode())
        body["tasks"] = self.get("tasks") or []
        req.entity = json.dumps(body).encode()
        return req
