"""The text encoder's whole-batch dropout draw against a draw in 16 row
blocks (a generator each) on the card: alone at BERT-base's attention
probabilities (128 x 12 x 128 x 128 bf16), for one process and for a
rank of two, and inside phase 17b's one-card BERT-base MoE step (batch
128 x 128, bf16, dropout 0.1), the two draws in turns.

    python3 tools/chip/dropout_draws.py
"""
import dataclasses, os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
import numpy as np
import torch
from synapseml_tpu_torch.models.dl import (DeepTextClassifier, DLTrainer,
                                           OptimizerConfig, TextEncoder,
                                           resolve_precision)
from synapseml_tpu_torch.models.dl import transformer as PT

dev = torch.device("cuda", 0)
whole = PT.dropout


def blocks(x, rate, seed, rows=None, K=16):
    """``PT.dropout`` drawn in ``K`` row blocks, each from a generator
    seeded with ``mix_seed(seed, block)``; a rank draws the blocks its
    rows touch."""
    if seed is None or rate <= 0.0:
        return x
    n = x.shape[0]
    lo, total = rows if rows is not None else (0, n)
    g = -(-total // K)
    keep = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    for j in range(lo // g, -(-(lo + n) // g)):
        a, b = j * g, min((j + 1) * g, total)
        gen = torch.Generator(device=x.device)
        gen.manual_seed(PT.mix_seed(seed, j))
        u = torch.rand((b - a,) + tuple(x.shape[1:]), generator=gen,
                       device=x.device)
        s, e = max(a, lo), min(b, lo + n)
        torch.lt(u[s - a:e - a], 1.0 - rate, out=keep[s - lo:e - lo])
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def timed(fn, n=37):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


x = torch.ones(128, 12, 128, 128, device=dev, dtype=torch.bfloat16)
print("draw ms at (128,12,128,128) bf16:", {
    "whole": timed(lambda: whole(x, 0.1, 5)),
    "blocks16": timed(lambda: blocks(x, 0.1, 5)),
    "rank_of_2_whole": timed(lambda: whole(x[:64], 0.1, 5, rows=(0, 128))),
    "rank_of_2_blocks16": timed(lambda: blocks(x[:64], 0.1, 5,
                                               rows=(0, 128)))}, flush=True)
del x
est = DeepTextClassifier(modelSize="base", vocabSize=30522, maxTokenLen=128,
                         batchSize=128, numExperts=8, moeTopK=2)
pol = resolve_precision("bf16")
cfg = dataclasses.replace(est._model_config(2), dtype=pol.compute_dtype)
tr = DLTrainer(TextEncoder(cfg, device=dev, seed=None),
               OptimizerConfig(learning_rate=2e-5), dev, precision=pol)
state = tr.init_state(0)
rng = np.random.default_rng(0)
ids = rng.integers(0, 30522, (128, 128)).astype(np.int32)
bi, bm, bl = tr.shard_batch((ids, np.ones((128, 128), bool),
                             rng.integers(0, 2, 128).astype(np.int32)))
step = tr.train_step()
box = [state]


def window(n=8):
    for _ in range(2):
        box[0], m = step(box[0], (bi, bm), bl, 0)
    float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(n):
        box[0], m = step(box[0], (bi, bm), bl, 0)
    float(m["loss"])
    return (time.perf_counter() - t0) / n * 1e3


res = {"whole": [], "blocks16": []}
for impl in ("whole", "blocks16", "blocks16", "whole"):
    PT.dropout = whole if impl == "whole" else blocks
    res[impl].append(window())
print("17b one-card step ms (dropout 0.1, batch 128 x 128, bf16):", res,
      flush=True)
