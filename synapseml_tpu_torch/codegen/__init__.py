"""Multi-language binding codegen (reference L7: core/.../codegen/).

The reference mixes ``Wrappable`` into every stage and ``CodeGen.main``
(reference: codegen/CodeGen.scala:25, codegen/Wrappable.scala:52,369)
emits PySpark/R/.NET wrappers from Spark param metadata.  Here the param
metadata lives on :class:`~synapseml_tpu_torch.core.params.Param`
descriptors, and the generators — the PyTorch port's copy of the JAX
package's ``codegen``, walking the port's own stages — emit

- Python type stubs (``.pyi``) — IDE/typing surface for every stage,
- R wrappers over ``reticulate`` — one constructor function per stage,
- C# (.NET) wrapper classes over the Python.NET bridge shape,
- Markdown API docs — one page per module.

``generate_all(out_dir)`` is the ``sbt codegen`` analogue.
"""

from .discovery import discover_stages, load_all_modules
from .pygen import generate_pyi
from .rgen import generate_r
from .dotnetgen import generate_dotnet
from .docgen import generate_docs
from .testgen import generate_pytests
from .validate import validate_all


def generate_all(out_dir: str) -> dict:
    """Run every generator (reference: CodeGen.main + sbt codegen task,
    project/CodegenPlugin.scala:62-66).  Returns {language: [paths]}."""
    import os
    stages = discover_stages()
    return {
        "pyi": generate_pyi(stages, os.path.join(out_dir, "python")),
        "r": generate_r(stages, os.path.join(out_dir, "R")),
        "cs": generate_dotnet(stages, os.path.join(out_dir, "dotnet")),
        "docs": generate_docs(stages, os.path.join(out_dir, "docs")),
    }


__all__ = ["discover_stages", "load_all_modules", "generate_all",
           "generate_pyi", "generate_r", "generate_dotnet",
           "generate_docs", "generate_pytests", "validate_all"]
