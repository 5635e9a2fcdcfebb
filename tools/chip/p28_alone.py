"""Phase 28 of ``chip_smoke.py`` alone on the card: build the kernels
(28d's GBDT fits load them), then ``chip_smoke.dl_gang`` with phase 17b's
reference steps run in this process.  A stack dump of every thread after
240 s shows where a stall sits.

    python3 tools/chip/p28_alone.py
"""
import faulthandler
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from synapseml_tpu_torch.kernels._build import build_all  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: phase 28 runs on a card")
        return 1
    t0 = time.time()
    build_all()
    print("build", time.time() - t0, flush=True)
    card = cs.gpu_line()
    print(card, flush=True)
    faulthandler.dump_traceback_later(240, exit=False)
    t0 = time.time()
    cs.dl_gang(0, torch.device("cuda", 0), card, None)
    print("phase 28 wall", time.time() - t0, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
