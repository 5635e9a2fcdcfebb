"""Form-recognizer service stages (reference: cognitive/.../form/
FormRecognizer.scala — AnalyzeLayout, AnalyzeReceipts, AnalyzeBusinessCards,
AnalyzeInvoices, AnalyzeIDDocuments, AnalyzeCustomModel; FormOntology.scala
FormOntologyLearner/FormOntologyTransformer).

The PyTorch port's copy of the JAX package's ``services/form.py``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..core.dataset import Dataset
from ..core.params import BoolParam, DictParam, StringParam
from ..core.pipeline import Estimator, Model
from .vision import _ImageServiceBase


class _FormRecognizerBase(_ImageServiceBase):
    """Shared analyze-document request shape (reference:
    FormRecognizer.scala HasPages/includeTextDetails query params)."""

    pages = StringParam(doc="page selection, e.g. '1-3'", default="")
    includeTextDetails = BoolParam(doc="include text lines", default=False)

    def _query(self, row):
        q = {}
        if self.pages:
            q["pages"] = self.pages
        if bool(self.includeTextDetails):
            q["includeTextDetails"] = "true"
        return q

    def parse_response(self, value: Any) -> Any:
        if isinstance(value, dict) and "analyzeResult" in value:
            return value["analyzeResult"]
        return value


class AnalyzeLayout(_FormRecognizerBase):
    """Layout extraction (reference: FormRecognizer.scala AnalyzeLayout)."""


class AnalyzeReceipts(_FormRecognizerBase):
    """Receipt field extraction (reference: FormRecognizer.scala
    AnalyzeReceipts)."""


class AnalyzeBusinessCards(_FormRecognizerBase):
    """Business-card extraction (reference: FormRecognizer.scala
    AnalyzeBusinessCards)."""


class AnalyzeInvoices(_FormRecognizerBase):
    """Invoice extraction (reference: FormRecognizer.scala
    AnalyzeInvoices)."""


class AnalyzeIDDocuments(_FormRecognizerBase):
    """ID-document extraction (reference: FormRecognizer.scala
    AnalyzeIDDocuments)."""


class AnalyzeCustomModel(_FormRecognizerBase):
    """Custom-model analysis (reference: FormRecognizer.scala
    AnalyzeCustomModel — modelId routed into the URL by the caller)."""

    modelId = StringParam(doc="custom model id", default="")


def _merge_ontology(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Union two nested field-name→type trees, recursing into dicts."""
    out = dict(a)
    for k, v in b.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge_ontology(out[k], v)
        else:
            out.setdefault(k, v)
    return out


def _fields_to_ontology(fields: Any) -> Dict[str, Any]:
    if not isinstance(fields, dict):
        return {}
    out: Dict[str, Any] = {}
    for name, spec in fields.items():
        if isinstance(spec, dict):
            t = spec.get("type", "string")
            if t == "object":
                out[name] = _fields_to_ontology(spec.get("valueObject", {}))
            else:
                out[name] = t
        else:
            out[name] = type(spec).__name__
    return out


class FormOntologyLearner(Estimator):
    """Learn the union schema of analyzed form fields (reference:
    form/FormOntologyLearner.scala — aggregates documentResults.fields
    across rows into one ontology, then projects each row onto it)."""

    inputCol = StringParam(doc="analyzeResult column", default="form")
    outputCol = StringParam(doc="projected fields column", default="fields")

    def _fit(self, ds: Dataset) -> "FormOntologyModel":
        ontology: Dict[str, Any] = {}
        for v in ds[self.inputCol]:
            for doc in (v or {}).get("documentResults", []):
                ontology = _merge_ontology(
                    ontology, _fields_to_ontology(doc.get("fields", {})))
        return FormOntologyModel(ontology=ontology,
                                 inputCol=self.inputCol,
                                 outputCol=self.outputCol)


class FormOntologyModel(Model):
    """Project each row's fields onto the learned ontology."""

    inputCol = StringParam(doc="analyzeResult column", default="form")
    outputCol = StringParam(doc="projected fields column", default="fields")
    ontology = DictParam(doc="field-name → type tree", default=None)

    @staticmethod
    def _extract(spec: Any) -> Any:
        """Pull the value out of a field spec; recurse into objects."""
        if not isinstance(spec, dict):
            return spec
        if spec.get("type") == "object":
            return {k: FormOntologyModel._extract(v)
                    for k, v in (spec.get("valueObject") or {}).items()}
        for key in ("valueString", "valueNumber", "valueDate",
                    "valueInteger", "text"):
            if key in spec:
                return spec[key]
        return None

    def _transform(self, ds: Dataset) -> Dataset:
        onto = self.get("ontology") or {}
        out = np.empty(ds.num_rows, dtype=object)
        for i, v in enumerate(ds[self.inputCol]):
            fields: Dict[str, Any] = {}
            for doc in (v or {}).get("documentResults", []):
                for name, spec in (doc.get("fields") or {}).items():
                    if name in onto:
                        fields[name] = self._extract(spec)
            out[i] = fields
        return ds.with_column(self.outputCol, out)
