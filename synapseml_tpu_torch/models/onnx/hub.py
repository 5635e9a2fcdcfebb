"""ONNXHub — model-zoo loader with a local cache.

Re-designs the reference's hub client (reference: deep-learning/.../onnx/
ONNXHub.scala:72-255 — manifest download, SHA-256 verification, cache
directory).  This environment has no egress, so downloads are gated:
models resolve from the cache directory (or an explicit local manifest)
and a clear error names the missing file otherwise.  SHA-256 checks and
the manifest schema match the reference semantics.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache",
                              "synapseml_tpu", "onnx_hub")


@dataclass
class ONNXHubModelInfo:
    model: str
    model_path: str
    onnx_sha: Optional[str] = None
    opset: Optional[int] = None
    tags: List[str] = field(default_factory=list)


class ONNXHub:
    """Local-cache ONNX model hub (network access intentionally absent)."""

    def __init__(self, cache_dir: Optional[str] = None):
        self.cache_dir = cache_dir or os.environ.get(
            "SYNAPSEML_TPU_ONNX_HUB", _DEFAULT_CACHE)

    def manifest_path(self) -> str:
        return os.path.join(self.cache_dir, "ONNX_HUB_MANIFEST.json")

    def list_models(self, tags: Optional[List[str]] = None
                    ) -> List[ONNXHubModelInfo]:
        path = self.manifest_path()
        if not os.path.exists(path):
            return []
        with open(path) as f:
            raw = json.load(f)
        infos = [ONNXHubModelInfo(
            model=e.get("model", ""),
            model_path=e.get("model_path", ""),
            onnx_sha=(e.get("metadata", {}) or {}).get("model_sha"),
            opset=e.get("opset_version"),
            tags=(e.get("metadata", {}) or {}).get("tags", []),
        ) for e in raw]
        if tags:
            wanted = {t.lower() for t in tags}
            infos = [i for i in infos
                     if wanted & {t.lower() for t in i.tags}]
        return infos

    def get_model_path(self, name: str) -> str:
        for info in self.list_models():
            if info.model.lower() == name.lower():
                local = os.path.join(self.cache_dir, info.model_path)
                if os.path.exists(local):
                    if info.onnx_sha:
                        self._verify_sha(local, info.onnx_sha)
                    return local
                raise FileNotFoundError(
                    f"model {name!r} is in the manifest but "
                    f"{local} is absent; this build has no network egress — "
                    f"place the file there manually")
        direct = os.path.join(self.cache_dir, name)
        if os.path.exists(direct):
            return direct
        raise FileNotFoundError(
            f"model {name!r} not found under {self.cache_dir}; no network "
            f"egress is available to download it")

    def load_model(self, name: str) -> bytes:
        with open(self.get_model_path(name), "rb") as f:
            return f.read()

    @staticmethod
    def _verify_sha(path: str, expected: str) -> None:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if h.hexdigest().lower() != expected.lower():
            raise IOError(f"SHA-256 mismatch for {path}: "
                          f"{h.hexdigest()} != {expected}")
