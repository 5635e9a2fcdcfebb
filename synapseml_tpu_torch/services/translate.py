"""Translator service stages (reference: cognitive/.../translate/
Translator.scala — Translate, Transliterate, Detect, BreakSentence,
DictionaryLookup, DictionaryExamples; all post
``[{"Text": ...}]`` arrays with language routing in query params).

The PyTorch port's copy of the JAX package's ``services/translate.py``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from ..core.params import ListParam, StringParam
from ..io.http import HTTPRequestData
from .base import RemoteServiceTransformer, ServiceParam, with_query


class _TranslatorBase(RemoteServiceTransformer):
    textCol = StringParam(doc="input text column", default="text")

    def _query(self, row: Dict[str, Any]) -> Dict[str, str]:
        return {}

    def _body_items(self, row: Dict[str, Any]) -> List[Dict[str, Any]]:
        return [{"Text": str(row[self.textCol])}]

    def prepare_request(self, row: Dict[str, Any]) -> HTTPRequestData:
        url = with_query(self.url, self._query(row))
        body = json.dumps(self._body_items(row)).encode()
        return HTTPRequestData(url=url, method="POST",
                               headers={"Content-Type": "application/json"},
                               entity=body)

    def parse_response(self, value: Any) -> Any:
        if isinstance(value, list) and value:
            return value[0]
        return value


class Translate(_TranslatorBase):
    """Text translation (reference: Translator.scala Translate —
    ``toLanguage`` repeated query param, optional fromLanguage)."""

    toLanguage = ListParam(doc="target language codes", default=None)
    fromLanguage = ServiceParam(doc="source language (value or column)")

    def _query(self, row):
        q: Dict[str, Any] = {"to": self.get("toLanguage") or ["en"]}
        src = self.resolve_service_param("fromLanguage", row)
        if src:
            q["from"] = src
        return q

    def parse_response(self, value: Any) -> Any:
        v = super().parse_response(value)
        if isinstance(v, dict) and "translations" in v:
            return v["translations"]
        return v


class Transliterate(_TranslatorBase):
    """Script conversion (reference: Translator.scala Transliterate)."""

    language = StringParam(doc="language code", default="ja")
    fromScript = StringParam(doc="source script", default="Jpan")
    toScript = StringParam(doc="target script", default="Latn")

    def _query(self, row):
        return {"language": self.language, "fromScript": self.fromScript,
                "toScript": self.toScript}


class Detect(_TranslatorBase):
    """Language detection (reference: Translator.scala Detect)."""


class BreakSentence(_TranslatorBase):
    """Sentence segmentation (reference: Translator.scala BreakSentence)."""


class DictionaryLookup(_TranslatorBase):
    """Dictionary alternatives (reference: Translator.scala
    DictionaryLookup)."""

    fromLanguage = StringParam(doc="source language", default="en")
    toLanguage = StringParam(doc="target language", default="es")

    def _query(self, row):
        return {"from": self.fromLanguage, "to": self.toLanguage}


class DictionaryExamples(_TranslatorBase):
    """Usage examples for a translation pair (reference: Translator.scala
    DictionaryExamples — posts {Text, Translation} pairs)."""

    translationCol = StringParam(doc="translation column",
                                 default="translation")
    fromLanguage = StringParam(doc="source language", default="en")
    toLanguage = StringParam(doc="target language", default="es")

    def _query(self, row):
        return {"from": self.fromLanguage, "to": self.toLanguage}

    def _body_items(self, row):
        return [{"Text": str(row[self.textCol]),
                 "Translation": str(row[self.translationCol])}]
