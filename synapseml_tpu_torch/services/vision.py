"""Computer-vision service stages (reference: cognitive/.../vision/
ComputerVision.scala — AnalyzeImage, DescribeImage, OCR, ReadImage,
TagImage, GenerateThumbnails, RecognizeDomainSpecificContent).

Each stage posts either an image URL (``{"url": ...}`` JSON body) or raw
image bytes (octet-stream) per row, mirroring the reference's
``HasImageInput`` dual input mode (ComputerVision.scala imageUrl/
imageBytes ServiceParams).

The PyTorch port's copy of the JAX package's ``services/vision.py``.
"""

from __future__ import annotations

import json
from typing import Any, Dict

from ..core.params import BoolParam, IntParam, ListParam, StringParam
from ..io.http import HTTPRequestData
from .base import RemoteServiceTransformer, ServiceParam, with_query


class _ImageServiceBase(RemoteServiceTransformer):
    """Shared image-input handling (reference: ComputerVision.scala
    HasImageInput — imageUrl or imageBytes, scalar or column)."""

    imageUrl = ServiceParam(doc="image URL (value or column)")
    imageBytes = ServiceParam(doc="raw image bytes (value or column)")

    def _query(self, row: Dict[str, Any]) -> Dict[str, str]:
        return {}

    def prepare_request(self, row: Dict[str, Any]) -> HTTPRequestData:
        url = with_query(self.url, self._query(row))
        img_url = self.resolve_service_param("imageUrl", row)
        if img_url is not None:
            return HTTPRequestData(
                url=url, method="POST",
                headers={"Content-Type": "application/json"},
                entity=json.dumps({"url": str(img_url)}).encode())
        data = self.resolve_service_param("imageBytes", row)
        if data is None:
            raise ValueError("set imageUrl or imageBytes (value or column)")
        return HTTPRequestData(
            url=url, method="POST",
            headers={"Content-Type": "application/octet-stream"},
            entity=bytes(data))


class AnalyzeImage(_ImageServiceBase):
    """Visual-feature analysis (reference: ComputerVision.scala
    AnalyzeImage — visualFeatures/details/language query params)."""

    visualFeatures = ListParam(doc="features to extract", default=None)
    details = ListParam(doc="domain-specific details", default=None)
    language = StringParam(doc="result language", default="en")

    def _query(self, row):
        q = {"language": self.language}
        if self.get("visualFeatures"):
            q["visualFeatures"] = ",".join(self.get("visualFeatures"))
        if self.get("details"):
            q["details"] = ",".join(self.get("details"))
        return q


class DescribeImage(_ImageServiceBase):
    """Caption generation (reference: ComputerVision.scala DescribeImage)."""

    maxCandidates = IntParam(doc="caption candidates", default=1)

    def _query(self, row):
        return {"maxCandidates": str(int(self.maxCandidates))}

    def parse_response(self, value: Any) -> Any:
        if isinstance(value, dict) and "description" in value:
            return value["description"]
        return value


class OCR(_ImageServiceBase):
    """Printed-text OCR (reference: ComputerVision.scala OCR)."""

    detectOrientation = BoolParam(doc="detect orientation", default=True)
    language = StringParam(doc="text language", default="unk")

    def _query(self, row):
        return {"language": self.language,
                "detectOrientation": str(bool(self.detectOrientation)).lower()}


class ReadImage(_ImageServiceBase):
    """Read API for dense text (reference: ComputerVision.scala ReadImage)."""

    language = StringParam(doc="text language", default="en")

    def _query(self, row):
        return {"language": self.language}

    def parse_response(self, value: Any) -> Any:
        if isinstance(value, dict) and "analyzeResult" in value:
            return value["analyzeResult"]
        return value


class TagImage(_ImageServiceBase):
    """Content tags (reference: ComputerVision.scala TagImage)."""

    def parse_response(self, value: Any) -> Any:
        if isinstance(value, dict) and "tags" in value:
            return value["tags"]
        return value


class GenerateThumbnails(_ImageServiceBase):
    """Smart-cropped thumbnails (reference: ComputerVision.scala
    GenerateThumbnails — width/height/smartCropping query params; the
    response entity is the image bytes, not JSON)."""

    width = IntParam(doc="thumbnail width", default=64)
    height = IntParam(doc="thumbnail height", default=64)
    smartCropping = BoolParam(doc="smart cropping", default=True)
    binary_output = True

    def _query(self, row):
        return {"width": str(int(self.width)),
                "height": str(int(self.height)),
                "smartCropping": str(bool(self.smartCropping)).lower()}


class RecognizeDomainSpecificContent(_ImageServiceBase):
    """Domain-model recognition, e.g. celebrities/landmarks (reference:
    ComputerVision.scala RecognizeDomainSpecificContent)."""

    model = StringParam(doc="domain model name", default="landmarks")

    def parse_response(self, value: Any) -> Any:
        if isinstance(value, dict) and "result" in value:
            return value["result"]
        return value
