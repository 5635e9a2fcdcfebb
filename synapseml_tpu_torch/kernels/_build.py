"""Build and load the port's CUDA kernels.

Each source under ``synapseml_tpu_torch/csrc`` compiles with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``.  The build happens at first use, into ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``), under a name that carries
a hash of the source and flags, so an edited source never loads a stale
library.  :func:`build_all` starts one ``nvcc`` per source and waits for
all of them.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
REPO_ROOT = _PKG.parent
BUILD_DIR = REPO_ROOT / "build" / "kernels"

#: library name -> source file, relative to the package
SOURCES: Dict[str, str] = {"gbdt_hist": "csrc/gbdt_hist.cu",
                            "paged_attn": "csrc/paged_attn.cu"}

#: library name -> compile-time limits, passed to ``nvcc`` as ``-D``
#: defines; the Python wrappers check their inputs against the same numbers
DEFINES: Dict[str, Dict[str, int]] = {
    "gbdt_hist": {
        "SML_MAX_SLOTS": 64,
        # the H100's opt-in shared memory per block (227 KB) less the
        # kernel's static routing table of 7 x SML_MAX_SLOTS int32
        "SML_MAX_SMEM": 232448 - 7 * 64 * 4,
    },
    "paged_attn": {
        # query rows one block keeps (S verify positions x the GQA group
        # of one kv head) and the largest head width; at both limits a
        # block of the f32 kernel takes 115,968 bytes of shared memory
        "SML_PA_MAX_ROWS": 64,
        "SML_PA_MAX_D": 128,
        # keys of a slot's span that one block of the bf16/f16 split
        # kernel takes (4 tiles of 64): the partials' workspace holds
        # ceil(max_len / SML_PA_SPLIT) chunks per (slot, kv head)
        "SML_PA_SPLIT": 256,
    },
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on ``PATH``,
    else ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels build only "
                       "where the CUDA toolkit is installed")


def _flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{k}={v}"
                              for k, v in DEFINES.get(name, {}).items())


def _target(name: str) -> Tuple[Path, Path]:
    src = _PKG / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return src, BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Build the named libraries (all by default), one ``nvcc`` each, all
    started together.  → ``{name: {"path", "seconds", "log", "cached"}}``;
    raises ``RuntimeError`` with the compiler's output if any build
    fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        src, lib = _target(name)
        if lib.exists():
            out[name] = {"path": str(lib), "seconds": 0.0, "log": "",
                         "cached": True}
            continue
        tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
        cmd = [nvcc_path(), *_flags(name), "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)      # atomic: a concurrent loader sees all or none
        out[name] = {"path": str(lib), "seconds": time.perf_counter() - t0,
                     "log": log, "cached": False}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The named kernel library, built first if needed."""
    return ctypes.CDLL(build_all([name])[name]["path"])
