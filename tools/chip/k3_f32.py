"""K3's f32 cases of ``chip_smoke.py``'s phase 6 alone on the card: the
paged_attn library built from the checkout (the compiler's register and
shared-memory report of each f32 split kernel printed), then
``chip_smoke.k3_case`` at the f32 shapes phase 6 holds, each a JSON line
(the kernel, the previous kernel in turns, plain, SDPA, bound).  With
``--gpu-tests``, then the ``gpu`` tests of K3.

    python3 tools/chip/k3_f32.py [--gpu-tests]
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: K3's kernels run on a card")
        return 1
    from synapseml_tpu_torch.kernels import _build
    print(cs.gpu_line(), torch.__version__, torch.version.cuda, flush=True)
    log = _build.build_all(["paged_attn"])["paged_attn"]["log"]
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "paged_f32_split_kernel" in line and "Compiling" in line:
            print("\n".join(lines[i:i + 4]), flush=True)
    dev = torch.device("cuda", 0)
    krng = np.random.default_rng(0)         # phase 6's draws at seed 0
    edges = [1, 63, 64, 65, 255, 256, 257, 2047, 2048]
    spans = np.concatenate([edges, krng.integers(1, 2049, 16 - len(edges))])
    cases = [("16x2048", 1, (16, 32, 8, 64, 2048, spans)),
             ("16x2048", 8, (16, 32, 8, 64, 2048, spans)),
             ("27a", 1, (4, 32, 8, 64, 512, [1, 64, 213, 512])),
             ("27a", 8, (4, 32, 8, 64, 512, [1, 64, 213, 512])),
             ("20a", 1, (4, 8, 4, 16, 128, [1, 31, 64, 128]))]
    for name, S, (B, H, KV, D, T, sp) in cases:
        r = cs.k3_case(dev, S, B, S, H, KV, D, T, torch.float32, sp)
        print(json.dumps(dict(case=name, S=S, **r)), flush=True)
    if "--gpu-tests" in sys.argv:
        return subprocess.call(
            [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
             "tests/test_torch_llm_cuda.py", "tests/test_torch_tuning_cuda.py"],
            cwd=ROOT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
