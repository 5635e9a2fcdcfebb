"""Build and load the port's CUDA kernels.

Each source under ``synapseml_tpu_torch/csrc`` compiles with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``.  The build happens at first use, into ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``), under a name that carries
a hash of the source and flags, so an edited source never loads a stale
library.  :func:`build_all` starts one ``nvcc`` per source and waits for
all of them.  Nothing here runs at import.

:func:`set_build_dir` points the builds elsewhere: a gang's ranks share
one directory that way (``parallel/compilecache.py``, the kernel build
cache), so a relaunched rank loads the library an earlier rank built.
Each library is reported once a process to the listeners
(:func:`add_build_listener`): ``("hit", name, 0.0)`` when it was found
in the directory, ``("miss", name, seconds)`` when ``nvcc`` built it.
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
from typing import Callable, Dict, Iterable, List, Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
REPO_ROOT = _PKG.parent
BUILD_DIR = REPO_ROOT / "build" / "kernels"

#: the directory builds go to when not :data:`BUILD_DIR`
_build_dir: Optional[Path] = None
#: callables ``fn(event, name, seconds)``, event "hit" or "miss"
_listeners: List[Callable[[str, str, float], None]] = []
#: library paths already reported in this process
_reported: set = set()


def build_dir() -> Path:
    """Where the libraries are built and looked for."""
    return _build_dir if _build_dir is not None else BUILD_DIR


def set_build_dir(path) -> None:
    """Build into and load from ``path`` (None: :data:`BUILD_DIR`)."""
    global _build_dir
    _build_dir = Path(path) if path is not None else None


def add_build_listener(fn: Callable[[str, str, float], None]) -> None:
    """Call ``fn(event, name, seconds)`` once a process for each library:
    ``"hit"`` when it was found built, ``"miss"`` when it was built."""
    if fn not in _listeners:
        _listeners.append(fn)


def _report(event: str, name: str, path: str, seconds: float) -> None:
    if path in _reported:
        return
    _reported.add(path)
    for fn in list(_listeners):
        fn(event, name, seconds)

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
        # block of the previous kernel takes 115,968 bytes of shared memory
        "SML_PA_MAX_ROWS": 64,
        "SML_PA_MAX_D": 128,
        # keys of a slot's span that one block of the bf16/f16 split
        # kernel takes (4 tiles of 64), and the most one block of the f32
        # split kernel takes: the partials' workspace holds
        # ceil(max_len / chunk) chunks per (slot, kv head)
        "SML_PA_SPLIT": 256,
        # the f32 split kernel: the grid its chunk length aims at (about
        # two blocks on each of the H100's 132 SMs), and the query rows x
        # head width one block keeps (a warp accumulates at most half:
        # 32 registers a lane)
        "SML_PA_F32_BLOCKS": 264,
        "SML_PA_F32_ACC": 2048,
        # the fewest chunks it cuts a cache row into, unless the row is
        # one chunk (there the combine's tail costs more than it saves)
        "SML_PA_F32_MIN_CHUNKS": 4,
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
    return src, build_dir() / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Build the named libraries (all by default), one ``nvcc`` each, all
    started together.  → ``{name: {"path", "seconds", "log", "cached"}}``;
    raises ``RuntimeError`` with the compiler's output if any build
    fails."""
    names = list(SOURCES) if names is None else list(names)
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        src, lib = _target(name)
        if lib.exists():
            out[name] = {"path": str(lib), "seconds": 0.0, "log": "",
                         "cached": True}
            _report("hit", name, str(lib), 0.0)
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
        _report("miss", name, str(lib), out[name]["seconds"])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The named kernel library, built first if needed."""
    return ctypes.CDLL(build_all([name])[name]["path"])
