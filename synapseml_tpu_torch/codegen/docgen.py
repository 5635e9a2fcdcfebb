"""Markdown API-doc generation (reference: the website docs are built
from the same Wrappable metadata — codegen/DocGen parts of
CodegenPlugin.scala).  One page per module: class, first doc line,
param table with types and defaults."""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List

from .common import PACKAGE, lang_types, public_params, py_default_repr, \
    short_module
from .discovery import stage_kind


def _page(module: str, classes: List[type]) -> str:
    lines = [f"# `{module}`", ""]
    for cls in sorted(classes, key=lambda c: c.__name__):
        lines.append(f"## {cls.__name__} ({stage_kind(cls)})")
        doc = (cls.__doc__ or "").strip()
        if doc:
            lines.append("")
            lines.append(doc.splitlines()[0])
        params = public_params(cls)
        if params:
            lines += ["", "| param | type | default | doc |",
                      "|---|---|---|---|"]
            for p in params:
                pytype, _, _ = lang_types(p)
                doc_text = (p.doc or "").replace("|", "\\|")
                lines.append(f"| `{p.name}` | `{pytype}` | "
                             f"`{py_default_repr(p)}` | {doc_text} |")
        lines.append("")
    return "\n".join(lines)


def generate_docs(stages: Dict[str, type], out_dir: str) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    by_module = defaultdict(list)
    for qual, cls in stages.items():
        by_module[cls.__module__].append(cls)
    paths = []
    index = [f"# {PACKAGE} API reference", "",
             "Generated from stage param metadata; regenerate with:", "",
             f"    python -c \"from {PACKAGE}.codegen import "
             "discover_stages, generate_docs; "
             "generate_docs(discover_stages(), 'docs/api')\"", ""]
    for module, classes in sorted(by_module.items()):
        fname = short_module(module).replace(".", "_") + ".md"
        path = os.path.join(out_dir, fname)
        with open(path, "w") as f:
            f.write(_page(module, classes))
        index.append(f"- [`{module}`]({fname}) — "
                     f"{len(classes)} stages")
        paths.append(path)
    # hand-maintained (non-stage) pages already in out_dir survive
    # regeneration and self-register in the index: anything *.md the
    # generator did not just write gets linked with its first-heading
    # one-liner (previously these links were manual post-edits that every
    # regeneration silently wiped)
    import re
    generated = {os.path.basename(p) for p in paths} | {"index.md"}
    #: a generated page's first line is exactly "# `<module>`" — a file
    #: matching it but absent from this run is a STALE generated page
    #: (its stage module was removed/renamed), not a hand-maintained one
    _generated_head = re.compile(r"^# `[\w.]+`$")
    manual = []
    for fname in sorted(os.listdir(out_dir)):
        if not fname.endswith(".md") or fname in generated:
            continue
        title = fname[:-3]
        try:
            with open(os.path.join(out_dir, fname)) as f:
                first = f.readline().rstrip("\n")
        except OSError:
            first = ""
        if _generated_head.match(first.strip()):
            continue                      # stale generated page: skip
        if first.lstrip("#").strip():
            title = first.lstrip("#").strip()
        manual.append((title, fname))
    if manual:
        index += ["", "Hand-maintained (non-stage) module pages:", ""]
        for title, fname in manual:
            index.append(f"- [{title}]({fname})")
    index_path = os.path.join(out_dir, "index.md")
    with open(index_path, "w") as f:
        f.write("\n".join(index) + "\n")
    paths.append(index_path)
    return paths
