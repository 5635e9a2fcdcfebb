"""Python ``.pyi`` stub generation (the PySpark-wrapper analogue,
reference: codegen/Wrappable.scala:52 ``PythonWrappable.pyInitFunc`` —
one keyword arg per param with its default).  Stubs give users the same
introspectable constructor surface the reference generates, as typing
files grouped per module."""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List

from .common import PACKAGE, lang_types, public_params, py_default_repr
from .discovery import stage_kind

_HEADER = (f"# Auto-generated by {PACKAGE}.codegen — do not edit.\n"
           "import typing\nimport numpy\n\n")


def _class_stub(cls: type) -> str:
    params = public_params(cls)
    lines = [f"class {cls.__name__}:"]
    doc = (cls.__doc__ or "").strip().splitlines()
    if doc:
        lines.append(f'    """{doc[0]}"""')
    for p in params:
        pytype, _, _ = lang_types(p)
        lines.append(f"    {p.name}: {pytype}")
    args = ", ".join(
        f"{p.name}: {lang_types(p)[0]} = {py_default_repr(p)}"
        for p in params)
    lines.append(f"    def __init__(self, *, {args}) -> None: ..."
                 if args else "    def __init__(self) -> None: ...")
    kind = stage_kind(cls)
    if kind == "estimator":
        lines.append("    def fit(self, ds) -> typing.Any: ...")
    if kind in ("transformer", "model"):
        lines.append("    def transform(self, ds) -> typing.Any: ...")
    lines.append("    def save(self, path: str, overwrite: bool = True)"
                 " -> None: ...")
    return "\n".join(lines) + "\n"


def generate_pyi(stages: Dict[str, type], out_dir: str) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    by_module = defaultdict(list)
    for qual, cls in stages.items():
        by_module[cls.__module__].append(cls)
    paths = []
    for module, classes in sorted(by_module.items()):
        rel = module.replace(".", os.sep) + ".pyi"
        path = os.path.join(out_dir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        body = _HEADER + "\n\n".join(
            _class_stub(c) for c in
            sorted(classes, key=lambda c: c.__name__))
        with open(path, "w") as f:
            f.write(body)
        paths.append(path)
    return paths
