"""Mechanical pytest generation from stage metadata — the reference's
``testgen`` (reference: Fuzzing.scala:263,428 emit Python/R/.NET tests
from the shared TestObjects; sbt task wired by
project/CodegenPlugin.scala:63).

For every discovered stage, a pytest module is EMITTED (not hand-
written) exercising the generated-binding contract against the live
class:

- the ``.pyi`` stub's constructor signature names exactly the stage's
  public params (a stub/reality mismatch fails),
- constructing the stage with each stub-declared default round-trips
  through set/get (the GetterSetterFuzzing shape, generated),
- ``copy()`` is param-independent of the original.

The committed suite generates these files fresh and runs them in a
subprocess (tests/test_torch_codegen.py), so a generator regression
produces failing GENERATED tests, not silently stale wrappers.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List

from .common import PACKAGE, public_params, short_module

_HEADER = (f'"""Auto-generated by {PACKAGE}.codegen.testgen — do not '
           'edit."""\n'
           + '''import ast
import importlib

import numpy as np


def _load(module, name):
    return getattr(importlib.import_module(module), name)


def _stub_init_args(pyi_path, cls_name):
    tree = ast.parse(open(pyi_path).read())
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and \\
                        item.name == "__init__":
                    return [a.arg for a in item.args.kwonlyargs]
    raise AssertionError(f"{cls_name}.__init__ missing from {pyi_path}")
''')


def _test_fn(cls: type, pyi_path: str) -> str:
    params = public_params(cls)
    names = [p.name for p in params]
    return f'''

def test_{cls.__name__.lower()}_binding_contract():
    cls = _load("{cls.__module__}", "{cls.__name__}")
    stub_args = _stub_init_args({pyi_path!r}, "{cls.__name__}")
    assert stub_args == {names!r}, (
        "stub signature drifted from the class param surface")
    stage = cls()
    for p in stage.params:
        if p.name not in {names!r}:
            continue
        if p.default is not None:
            v = stage.get_or_default(p.name)
            stage.set(p.name, v)
            got = stage.get(p.name)
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, got)
            else:
                assert got == v or got is v, p.name
    clone = stage.copy()
    assert clone._paramMap == stage._paramMap
    mutable = [p for p in clone.params
               if isinstance(clone.get_or_default(p.name), bool)]
    for p in mutable[:1]:
        before = stage.get_or_default(p.name)
        clone.set(p.name, not clone.get_or_default(p.name))
        assert stage.get_or_default(p.name) == before, (
            "copy() shares param state with the original")
'''


def generate_pytests(stages: Dict[str, type], pyi_paths: List[str],
                     out_dir: str) -> List[str]:
    """Emit one pytest file per python module; returns written paths."""
    os.makedirs(out_dir, exist_ok=True)
    by_module = defaultdict(list)
    for cls in stages.values():
        by_module[cls.__module__].append(cls)
    paths = []
    for module, classes in sorted(by_module.items()):
        rel = short_module(module)
        short = rel.replace(".", "_")
        # the pyi tree mirrors the package layout
        stub = next((p for p in pyi_paths
                     if p.endswith(rel.replace(".", os.sep) + ".pyi")), None)
        if stub is None:
            raise AssertionError(f"no stub generated for module {module}")
        body = _HEADER + "".join(
            _test_fn(c, stub) for c in sorted(classes,
                                              key=lambda c: c.__name__))
        path = os.path.join(out_dir, f"test_gen_{short}.py")
        with open(path, "w") as f:
            f.write(body)
        paths.append(path)
    return paths
