"""Pretrained-model downloader (reference: core/src/main/python/synapse/
ml/downloader/ModelDownloader.py:93-169 + the Scala side it wraps,
core/.../downloader/ — manifest of ModelSchema entries, sha256-verified
downloads into a local cache).

The PyTorch port's copy of the JAX package's ``downloader.py`` keeps the
same surface (``localModels`` / ``remoteModels``
/ ``downloadByName`` / ``downloadModel(s)``) with a JSON manifest served
over HTTP or present on disk; no JVM, no Spark session."""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import asdict, dataclass, field
from typing import Iterator, List, Optional

from .io.http import HTTPClient, HTTPRequestData


@dataclass
class ModelSchema:
    """One downloadable model (reference: ModelDownloader.py:15-51)."""

    name: str
    dataset: str = ""
    modelType: str = ""
    uri: str = ""
    hash: str = ""
    size: int = 0
    inputNode: int = 0
    numLayers: int = 0
    layerNames: List[str] = field(default_factory=list)

    def __repr__(self):
        return (f"ModelSchema<name: {self.name}, dataset: {self.dataset}, "
                f"loc: {self.uri}>")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class ModelDownloader:
    """Manifest-driven model cache (reference: ModelDownloader.py:93).

    ``server_url`` points at a directory serving ``manifest.json`` plus
    the model files; with no egress it can also be a local ``file://``
    directory path."""

    MANIFEST = "manifest.json"

    def __init__(self, local_path: str, server_url: str = ""):
        self.local_path = local_path
        self.server_url = server_url.rstrip("/")
        os.makedirs(local_path, exist_ok=True)
        self._http = HTTPClient()

    # -- listing -----------------------------------------------------------
    def localModels(self) -> Iterator[ModelSchema]:
        """Models already present + verified in the cache."""
        man = os.path.join(self.local_path, self.MANIFEST)
        if not os.path.exists(man):
            return
        with open(man) as f:
            entries = json.load(f)
        for e in entries:
            schema = ModelSchema(**e)
            target = self._target(schema)
            if os.path.exists(target):
                yield schema

    def remoteModels(self) -> Iterator[ModelSchema]:
        """Models listed by the server's manifest."""
        raw = self._fetch(self.MANIFEST)
        for e in json.loads(raw.decode()):
            yield ModelSchema(**e)

    # -- downloading -------------------------------------------------------
    def downloadModel(self, model: ModelSchema) -> ModelSchema:
        target = self._target(model)
        if not (os.path.exists(target) and
                (not model.hash or _sha256(target) == model.hash)):
            data = self._fetch(model.uri or model.name)
            with open(target, "wb") as f:
                f.write(data)
            if model.hash and _sha256(target) != model.hash:
                os.remove(target)
                raise ValueError(
                    f"hash mismatch for model {model.name}")
        self._record(model)
        out = ModelSchema(**asdict(model))
        out.uri = target
        return out

    def downloadByName(self, name: str) -> ModelSchema:
        for m in self.remoteModels():
            if m.name == name:
                return self.downloadModel(m)
        raise KeyError(f"model {name!r} not in remote manifest")

    def downloadModels(self, models: Optional[List[ModelSchema]] = None
                       ) -> List[ModelSchema]:
        if models is None:
            models = list(self.remoteModels())
        return [self.downloadModel(m) for m in models]

    # -- internals ---------------------------------------------------------
    def _target(self, model: ModelSchema) -> str:
        base = os.path.basename(model.uri or model.name) or model.name
        return os.path.join(self.local_path, base)

    def _record(self, model: ModelSchema) -> None:
        man = os.path.join(self.local_path, self.MANIFEST)
        entries = []
        if os.path.exists(man):
            with open(man) as f:
                entries = json.load(f)
        entries = [e for e in entries if e.get("name") != model.name]
        entries.append(asdict(model))
        with open(man, "w") as f:
            json.dump(entries, f, indent=1)

    def _fetch(self, rel: str) -> bytes:
        if rel.startswith(("http://", "https://")):
            url = rel
        elif self.server_url.startswith(("http://", "https://")):
            url = f"{self.server_url}/{rel}"
        else:
            # local directory server
            path = rel if os.path.isabs(rel) else os.path.join(
                self.server_url, rel)
            with open(path, "rb") as f:
                return f.read()
        resp = self._http.send(HTTPRequestData(url=url, method="GET"))
        if resp.status_code != 200:
            raise IOError(f"fetch {url} failed: "
                          f"{resp.status_code} {resp.reason}")
        return resp.entity
