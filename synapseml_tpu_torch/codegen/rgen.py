"""R wrapper generation (reference: codegen/Wrappable.scala:369
``RWrappable.makeRFile`` — one snake_cased constructor function per
stage with roxygen docs).  The emitted functions construct stages over
``reticulate``; each file mirrors one python module."""

from __future__ import annotations

import os
import re
from collections import defaultdict
from typing import Dict, List

from .common import PACKAGE, lang_types, public_params, short_module

_SNAKE_RE = re.compile(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])")


def _snake(name: str) -> str:
    return _SNAKE_RE.sub("_", name).lower()


def _r_default(p) -> str:
    d = p.default
    if d is None:
        return "NULL"
    if isinstance(d, bool):
        return "TRUE" if d else "FALSE"
    if isinstance(d, (int, float)):
        return repr(d)
    if isinstance(d, str):
        return '"' + d.replace('"', '\\"') + '"'
    return "NULL"


def _func(cls: type) -> str:
    params = public_params(cls)
    fname = "sml_" + _snake(cls.__name__)
    doc = (cls.__doc__ or cls.__name__).strip().splitlines()[0]
    lines = [f"#' {doc}", "#'"]
    for p in params:
        _, rtype, _ = lang_types(p)
        lines.append(f"#' @param {p.name} ({rtype}) {p.doc}")
    lines.append("#' @export")
    args = ", ".join(f"{p.name} = {_r_default(p)}" for p in params)
    lines.append(f"{fname} <- function({args}) {{")
    lines.append(f'  mod <- reticulate::import("{cls.__module__}")')
    lines.append(f"  args <- list({', '.join(p.name + ' = ' + p.name for p in params)})")
    lines.append("  args <- args[!vapply(args, is.null, logical(1))]")
    lines.append(f'  do.call(mod${cls.__name__}, args)')
    lines.append("}")
    return "\n".join(lines) + "\n"


def generate_r(stages: Dict[str, type], out_dir: str) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    by_module = defaultdict(list)
    for qual, cls in stages.items():
        by_module[cls.__module__].append(cls)
    paths = []
    for module, classes in sorted(by_module.items()):
        fname = short_module(module).replace(".", "_") + ".R"
        path = os.path.join(out_dir, fname)
        body = (f"# Auto-generated by {PACKAGE}.codegen — do not edit.\n\n"
                + "\n\n".join(_func(c) for c in
                              sorted(classes, key=lambda c: c.__name__)))
        with open(path, "w") as f:
            f.write(body)
        paths.append(path)
    return paths
