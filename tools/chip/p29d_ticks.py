"""Phase 29d's pipelined step on two gloo ranks sharing the card, twice:
the backward's wall and, tick by tick, the time in each
``torch.autograd.grad`` call and each ``ppermute`` of the schedule (card
synchronized around each); then the plain model's backward twice.
Prints each rank's record.

    python3 tools/chip/p29d_ticks.py
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def task(args):
    import chip_smoke as cs
    from synapseml_tpu_torch.parallel import collectives as C
    from synapseml_tpu_torch.parallel.mesh import ProcessMesh
    from synapseml_tpu_torch.models.dl import TextEncoder, TransformerConfig
    from synapseml_tpu_torch.models.dl.pipeline import split_encoder_stages, pp_train_loss
    from synapseml_tpu_torch.parallel.pipeline import local_stage
    torch.backends.cuda.matmul.allow_tf32 = False
    events = []
    real_grad, real_pp = torch.autograd.grad, C._ppermute

    def grad(*a, **k):
        torch.cuda.synchronize(); t0 = time.perf_counter()
        r = real_grad(*a, **k); torch.cuda.synchronize()
        events.append(("grad", time.perf_counter() - t0)); return r

    def pp(*a, **k):
        torch.cuda.synchronize(); t0 = time.perf_counter()
        r = real_pp(*a, **k); torch.cuda.synchronize()
        events.append((a[4], time.perf_counter() - t0)); return r

    torch.autograd.grad, C._ppermute = grad, pp
    mesh = ProcessMesh({"pipe": 2}, device="cuda")
    dev = mesh.device
    c = cs.P29_PIPE
    cfg = TransformerConfig(dtype=torch.float32, **c["cfg"])
    B, S = c["micro"] * c["mb"], cfg.max_len
    rng = np.random.default_rng(1)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)), device=dev)
    mask = torch.ones((B, S), dtype=torch.bool, device=dev)
    labels = torch.as_tensor(rng.integers(0, 2, B), device=dev)
    model = TextEncoder(cfg, device=dev, seed=0)
    whole = {k: v.detach() for k, v in model.state_dict().items()}
    outer, stacked = split_encoder_stages(whole, 2)
    out = {}
    for rep in range(2):
        events.clear()
        o = {k: v.clone().requires_grad_(True) for k, v in outer.items()}
        mine = {k: v.clone().requires_grad_(True) for k, v in local_stage(stacked, mesh).items()}
        loss = pp_train_loss(cfg, mesh, c["micro"])(o, mine, ids, mask, labels)
        torch.cuda.synchronize(); t0 = time.perf_counter()
        loss.backward(); torch.cuda.synchronize()
        out[rep] = dict(bwd=time.perf_counter() - t0,
                        events=[(n, round(t, 4)) for n, t in events])
    # the plain model's backward on this process, first and second
    for rep in range(2):
        model.zero_grad()
        torch.cuda.synchronize(); t0 = time.perf_counter()
        torch.nn.functional.cross_entropy(model(ids[:8], mask[:8]), labels[:8]).backward()
        torch.cuda.synchronize(); out[f"plain_{rep}"] = time.perf_counter() - t0
    return out


if __name__ == "__main__":
    from synapseml_tpu_torch.parallel import run_on_local_cluster
    res = run_on_local_cluster("p29d_ticks:task", 2, task_args={}, device="cuda", backend="gloo", timeout_s=600)
    for r in res:
        print(r)
