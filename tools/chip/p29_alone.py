"""Phase 29 of ``chip_smoke.py`` alone on the card (it launches no
kernel, so nothing is built): ``chip_smoke.model_parallel`` at full size,
then, with ``--gpu-tests``, ``tests/test_torch_dl_tp_cuda.py``.  A stack
dump of every thread after 300 s shows where a stall sits.

    python3 tools/chip/p29_alone.py [--gpu-tests]
"""
import faulthandler
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: phase 29 runs on a card")
        return 1
    card = cs.gpu_line()
    print(card, flush=True)
    faulthandler.dump_traceback_later(300, exit=False)
    t0 = time.time()
    cs.model_parallel(0, torch.device("cuda", 0), card)
    print("phase 29 wall", time.time() - t0, flush=True)
    faulthandler.cancel_dump_traceback_later()
    if "--gpu-tests" in sys.argv:
        return subprocess.call([sys.executable, "-m", "pytest", "-q", "-m",
                                "gpu", "tests/test_torch_dl_tp_cuda.py"],
                               cwd=ROOT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
