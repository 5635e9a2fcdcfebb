"""Geospatial service stages (reference: cognitive/.../geospatial/ —
AddressGeocoder, ReverseAddressGeocoder, CheckPointInPolygon).

The PyTorch port's copy of the JAX package's ``services/geospatial.py``.
"""

from __future__ import annotations

import json
from typing import Any, Dict

from ..core.params import StringParam
from ..io.http import HTTPRequestData
from .base import RemoteServiceTransformer, with_query


class _BatchGeocodeBase(RemoteServiceTransformer):
    """Shared one-item batchItems POST + unwrap (reference: geospatial/
    AddressGeocoder.scala / ReverseAddressGeocoder.scala share the batch
    request/response shape)."""

    def _geocode_query(self, row: Dict[str, Any]) -> str:
        raise NotImplementedError

    def prepare_request(self, row: Dict[str, Any]) -> HTTPRequestData:
        body = {"batchItems": [{"query": self._geocode_query(row)}]}
        return HTTPRequestData(url=self.url, method="POST",
                               headers={"Content-Type": "application/json"},
                               entity=json.dumps(body).encode())

    def parse_response(self, value: Any) -> Any:
        if isinstance(value, dict) and "batchItems" in value:
            items = value["batchItems"]
            return items[0] if items else None
        return value


class AddressGeocoder(_BatchGeocodeBase):
    """Address → lat/lon (reference: geospatial/AddressGeocoder.scala —
    batch geocode POST)."""

    addressCol = StringParam(doc="address column", default="address")

    def _geocode_query(self, row):
        return str(row[self.addressCol])


class ReverseAddressGeocoder(_BatchGeocodeBase):
    """Lat/lon → address (reference: geospatial/
    ReverseAddressGeocoder.scala)."""

    latitudeCol = StringParam(doc="latitude column", default="lat")
    longitudeCol = StringParam(doc="longitude column", default="lon")

    def _geocode_query(self, row):
        return (f"{float(row[self.latitudeCol])},"
                f"{float(row[self.longitudeCol])}")


class CheckPointInPolygon(RemoteServiceTransformer):
    """Point-in-polygon membership (reference: geospatial/
    CheckPointInPolygon.scala — GET with lat/lon + user data id)."""

    latitudeCol = StringParam(doc="latitude column", default="lat")
    longitudeCol = StringParam(doc="longitude column", default="lon")
    userDataIdentifier = StringParam(doc="uploaded polygon set id",
                                     default="")

    def prepare_request(self, row: Dict[str, Any]) -> HTTPRequestData:
        q = {"lat": float(row[self.latitudeCol]),
             "lon": float(row[self.longitudeCol])}
        if self.userDataIdentifier:
            q["udid"] = self.userDataIdentifier
        return HTTPRequestData(url=with_query(self.url, q), method="GET")

    def parse_response(self, value: Any) -> Any:
        if isinstance(value, dict) and "result" in value:
            return value["result"]
        return value
