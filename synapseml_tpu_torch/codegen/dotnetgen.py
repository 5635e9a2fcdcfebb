""".NET wrapper generation (reference: codegen/DotnetCodegen.scala +
``DotnetWrappable`` — one C# class per stage with typed setters).  The
emitted classes target the Python.NET bridge shape: property setters
feed a param dictionary handed to the python constructor."""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List

from .common import PACKAGE, lang_types, public_params, short_module
from .discovery import stage_kind

_CS_KEYWORDS = {"params", "base", "object", "string", "event", "lock"}


def _cs_name(name: str) -> str:
    n = name[0].upper() + name[1:]
    return n + "_" if n.lower() in _CS_KEYWORDS else n


def _class(cls: type) -> str:
    params = public_params(cls)
    doc = (cls.__doc__ or cls.__name__).strip().splitlines()[0]
    lines = ["    /// <summary>", f"    /// {doc}", "    /// </summary>",
             f"    public class {cls.__name__} : PythonStage", "    {",
             f'        public {cls.__name__}() : base('
             f'"{cls.__module__}", "{cls.__qualname__}") {{ }}', ""]
    for p in params:
        _, _, cstype = lang_types(p)
        lines.append(f"        /// <summary>{p.doc}</summary>")
        lines.append(
            f"        public {cls.__name__} Set{_cs_name(p.name)}"
            f"({cstype} value) => "
            f'({cls.__name__})Set("{p.name}", value);')
    kind = stage_kind(cls)
    if kind == "estimator":
        lines.append("        public PythonStage Fit(PythonDataset ds)"
                     ' => Invoke("fit", ds);')
    if kind in ("transformer", "model"):
        lines.append("        public PythonDataset Transform("
                     "PythonDataset ds) => "
                     'InvokeDataset("transform", ds);')
    lines.append("    }")
    return "\n".join(lines)


#: the runtime base the generated classes extend — the minimal equivalent
#: of the reference's .NET runtime base (reference:
#: core/src/main/dotnet/src/ — DotnetBase + Param helpers).  Bridges over
#: Python.NET: a stage is a held python object; Set() writes params,
#: Invoke() calls fit/transform.  Ships WITH the generated output so the
#: wrappers are a complete compilable source set.
_RUNTIME_BASE = """// SynapseMLTpu .NET runtime base — generated alongside the wrappers.
using System;
using Python.Runtime;

namespace SynapseMLTpu.Runtime
{
    /// <summary>A Dataset handle held on the python side.</summary>
    public class PythonDataset
    {
        public readonly PyObject Handle;
        public PythonDataset(PyObject handle) { Handle = handle; }
    }

    /// <summary>Base for every generated stage wrapper: constructs the
    /// python stage by module + qualified name and forwards params and
    /// fit/transform calls over Python.NET.</summary>
    public abstract class PythonStage : IDisposable
    {
        protected PyObject Stage;

        protected PythonStage(string module, string qualName)
        {
            using (Py.GIL())
            {
                dynamic mod = Py.Import(module);
                PyObject target = mod;
                foreach (var part in qualName.Split('.'))
                    target = target.GetAttr(part);
                Stage = target.Invoke();
            }
        }

        protected PythonStage Set(string name, object value)
        {
            using (Py.GIL())
                Stage.InvokeMethod("set", new PyString(name),
                                   value.ToPython());
            return this;
        }

        protected PythonStage Invoke(string method, PythonDataset ds)
        {
            using (Py.GIL())
                Stage = Stage.InvokeMethod(method, ds.Handle);
            return this;
        }

        protected PythonDataset InvokeDataset(string method,
                                              PythonDataset ds)
        {
            using (Py.GIL())
                return new PythonDataset(
                    Stage.InvokeMethod(method, ds.Handle));
        }

        public void Dispose()
        {
            using (Py.GIL()) Stage?.Dispose();
        }
    }
}
"""


def generate_dotnet(stages: Dict[str, type], out_dir: str) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    runtime_path = os.path.join(out_dir, "PythonStage.cs")
    with open(runtime_path, "w") as f:
        f.write(_RUNTIME_BASE)
    by_module = defaultdict(list)
    for qual, cls in stages.items():
        by_module[cls.__module__].append(cls)
    paths = [runtime_path]
    for module, classes in sorted(by_module.items()):
        short = short_module(module)
        ns = "SynapseMLTpu." + ".".join(
            s.capitalize() for s in short.split("."))
        fname = short.replace(".", "_") + ".cs"
        path = os.path.join(out_dir, fname)
        body = (f"// Auto-generated by {PACKAGE}.codegen — do not edit.\n"
                "using SynapseMLTpu.Runtime;\n\n"
                f"namespace {ns}\n{{\n"
                + "\n\n".join(_class(c) for c in
                              sorted(classes, key=lambda c: c.__name__))
                + "\n}\n")
        with open(path, "w") as f:
            f.write(body)
        paths.append(path)
    return paths
