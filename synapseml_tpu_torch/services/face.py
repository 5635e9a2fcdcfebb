"""Face service stages (reference: cognitive/.../face/Face.scala —
DetectFace, FindSimilarFace, GroupFaces, IdentifyFaces, VerifyFaces).

The PyTorch port's copy of the JAX package's ``services/face.py``.
"""

from __future__ import annotations

import json
from typing import Any, Dict

from ..core.params import BoolParam, IntParam, ListParam, StringParam
from ..io.http import HTTPRequestData
from .base import RemoteServiceTransformer, ServiceParam
from .vision import _ImageServiceBase


class DetectFace(_ImageServiceBase):
    """Face detection with optional attributes (reference: Face.scala
    DetectFace — returnFaceId/returnFaceLandmarks/returnFaceAttributes)."""

    returnFaceId = BoolParam(doc="include face ids", default=True)
    returnFaceLandmarks = BoolParam(doc="include landmarks", default=False)
    returnFaceAttributes = ListParam(doc="attribute names", default=None)

    def _query(self, row):
        q = {"returnFaceId": str(bool(self.returnFaceId)).lower(),
             "returnFaceLandmarks":
                 str(bool(self.returnFaceLandmarks)).lower()}
        if self.get("returnFaceAttributes"):
            q["returnFaceAttributes"] = ",".join(
                self.get("returnFaceAttributes"))
        return q


class _JsonBodyFaceStage(RemoteServiceTransformer):
    """Faces stages whose request is a JSON body assembled from
    ServiceParams (reference: Face.scala FindSimilar/Group/Identify/
    Verify all post JSON)."""

    def _body(self, row: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    def prepare_request(self, row: Dict[str, Any]) -> HTTPRequestData:
        return HTTPRequestData(
            url=self.url, method="POST",
            headers={"Content-Type": "application/json"},
            entity=json.dumps(self._body(row)).encode())


class FindSimilarFace(_JsonBodyFaceStage):
    """Similar-face search (reference: Face.scala FindSimilarFace)."""

    faceId = ServiceParam(doc="query face id (value or column)")
    faceIds = ServiceParam(doc="candidate face ids (value or column)")
    maxNumOfCandidatesReturned = IntParam(doc="max candidates", default=20)
    mode = StringParam(doc="matchPerson | matchFace", default="matchPerson")

    def _body(self, row):
        return {"faceId": self.resolve_service_param("faceId", row),
                "faceIds": self.resolve_service_param("faceIds", row),
                "maxNumOfCandidatesReturned":
                    int(self.maxNumOfCandidatesReturned),
                "mode": self.mode}


class GroupFaces(_JsonBodyFaceStage):
    """Cluster face ids (reference: Face.scala GroupFaces)."""

    faceIds = ServiceParam(doc="face ids to group (value or column)")

    def _body(self, row):
        return {"faceIds": self.resolve_service_param("faceIds", row)}


class IdentifyFaces(_JsonBodyFaceStage):
    """Identify against a person group (reference: Face.scala
    IdentifyFaces)."""

    faceIds = ServiceParam(doc="face ids (value or column)")
    personGroupId = ServiceParam(doc="person group id")
    maxNumOfCandidatesReturned = IntParam(doc="max candidates", default=1)
    confidenceThreshold = ServiceParam(doc="confidence threshold")

    def _body(self, row):
        body = {"faceIds": self.resolve_service_param("faceIds", row),
                "personGroupId":
                    self.resolve_service_param("personGroupId", row),
                "maxNumOfCandidatesReturned":
                    int(self.maxNumOfCandidatesReturned)}
        thr = self.resolve_service_param("confidenceThreshold", row)
        if thr is not None:
            body["confidenceThreshold"] = float(thr)
        return body


class VerifyFaces(_JsonBodyFaceStage):
    """Same-person verification (reference: Face.scala VerifyFaces)."""

    faceId1 = ServiceParam(doc="first face id (value or column)")
    faceId2 = ServiceParam(doc="second face id (value or column)")

    def _body(self, row):
        return {"faceId1": self.resolve_service_param("faceId1", row),
                "faceId2": self.resolve_service_param("faceId2", row)}
