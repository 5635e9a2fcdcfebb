"""The f32 split kernel of K3 timed at every chunk length on the card, to
settle ``paged_attn.f32_chunk_keys``.  Builds a copy of
``csrc/paged_attn.cu`` whose f32 entry point takes any chunk that is a
multiple of the 64-key tile up to ``SML_PA_SPLIT`` (the checkout's own
entry point takes only the rule's), prints the opcode counts of the
compiled kernel at D = 64, then for each of phase 6's f32 shapes and each
chunk holds the kernel against the plain version (atol 1e-5) and times
it with ``chip_smoke.cuda_ms`` on cold copies of the cache, in turns
over the chunks, beside the previous kernel (``paged_decode_kernel``).
Each ``--source FILE`` (another version of ``paged_attn.cu``) is built
the same way and timed at the rule's chunk in the same turns, so two
versions compare on one card.

    python3 tools/chip/k3_f32_chunks.py [--source FILE ...]
"""
import collections
import ctypes
import itertools
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

RULE = "  if (chunk != f32_chunk_keys(B, KV, T_len, row_chunks))\n"
ANY = "  if (chunk < kTile || chunk > kSplit || chunk % kTile)\n"


def build(path: str, name: str):
    from synapseml_tpu_torch.kernels import _build
    src = open(path).read()
    assert src.count(RULE) == 1
    out = os.path.join(ROOT, "build", "k3_chunks")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, f"{name}.cu"), os.path.join(
        out, f"lib{name}.so")
    open(cu, "w").write(src.replace(RULE, ANY))
    subprocess.run([_build.nvcc_path(), *_build._flags("paged_attn"), "-o",
                    so, cu], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sml_paged_decode_attention_split_f32.argtypes = [
        P, P, P, P, P, P, P, I, I, I, I, I, ctypes.c_longlong, I,
        ctypes.c_float, P]
    return lib, so


def sass_counts(so: str) -> dict:
    """Opcode counts of paged_f32_split_kernel<64> in the library."""
    tool = "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    dump = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True).stdout
    body, on = [], False
    for line in dump.splitlines():
        if "Function :" in line:
            on = "paged_f32_split_kernelILi64" in line
        elif on:
            body.append(line)
    ops = collections.Counter(
        m.group(1).split(".")[0] for m in
        (re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", ln)
         for ln in body) if m)
    return dict(ops.most_common(30))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: K3's kernels run on a card")
        return 1
    from synapseml_tpu_torch.models.llm import paged_attn as PA
    print(cs.gpu_line(), flush=True)
    others = [a for i, a in enumerate(sys.argv[1:], 1)
              if sys.argv[i - 1] == "--source"]
    lib, so = build(os.path.join(ROOT, "synapseml_tpu_torch", "csrc",
                                 "paged_attn.cu"), "checkout")
    libs = {"checkout": lib}
    for i, path in enumerate(others):
        libs[path] = build(path, f"source{i}")[0]
    for name, l in libs.items():
        print(name, "sass D=64:", json.dumps(sass_counts(
            os.path.join(ROOT, "build", "k3_chunks",
                         "libcheckout.so" if name == "checkout" else
                         f"libsource{others.index(name)}.so"))), flush=True)
    dev = torch.device("cuda", 0)
    krng = np.random.default_rng(0)
    edges = [1, 63, 64, 65, 255, 256, 257, 2047, 2048]
    spans = np.concatenate([edges, krng.integers(1, 2049, 16 - len(edges))])
    cases = [("16x2048", 1, (16, 32, 8, 64, 2048, spans)),
             ("16x2048", 8, (16, 32, 8, 64, 2048, spans)),
             ("27a", 1, (4, 32, 8, 64, 512, [1, 64, 213, 512])),
             ("27a", 8, (4, 32, 8, 64, 512, [1, 64, 213, 512])),
             ("20a", 1, (4, 8, 4, 16, 128, [1, 31, 64, 128]))]
    for name, S, (B, H, KV, D, T, sp) in cases:
        g = torch.Generator(device=dev)
        g.manual_seed(S)
        q = torch.randn((B, S, H, D), generator=g, device=dev)
        k = torch.randn((B, T, KV, D), generator=g, device=dev)
        v = torch.randn((B, T, KV, D), generator=g, device=dev)
        spt = torch.as_tensor(np.asarray(sp, np.int32), device=dev)
        ref = PA.paged_decode_attention_plain(q, k, v, spt)
        rows = S * (H // KV)
        rc = -(-rows // PA.f32_rows_per_block(D))
        counters = torch.zeros(B * KV * rc, dtype=torch.int32, device=dev)
        kv = itertools.cycle([(k, v)] + [(k.clone(), v.clone())
                                         for _ in range(cs.K3_COPIES - 1)])
        sqrt_d = float(np.float32(np.sqrt(D)))
        chunks = [c for c in (64, 128, 256) if c <= PA.SPLIT_KEYS
                  and (c == 64 or c < 2 * T)]

        def call(C, lib=lib):
            ws = torch.empty((B, KV, -(-T // C), rows, D + 4),
                             dtype=torch.float32, device=dev)
            out = torch.empty_like(q)
            kk, vv = next(kv)
            rc_ = lib.sml_paged_decode_attention_split_f32(
                q.data_ptr(), kk.data_ptr(), vv.data_ptr(), spt.data_ptr(),
                out.data_ptr(), ws.data_ptr(), counters.data_ptr(), B, S, H,
                KV, D, T, C, sqrt_d, torch.cuda.current_stream().cuda_stream)
            assert rc_ == 0, rc_
            return out
        lim = spt.long()[:, None] - (S - 1) + torch.arange(S, device=dev)
        live = lim > 0
        rule = PA.f32_chunk_keys(B, KV, T, rows, D)
        runs = [("checkout", C) for C in chunks] + [
            (n, rule) for n in libs if n != "checkout"]
        err = {}
        for n, C in runs:
            for _ in range(cs.K3_COPIES):      # every copy: same K/V values
                got = call(C, libs[n])
                err[f"{n}@{C}"] = float((got - ref).abs()[live].max())
                assert err[f"{n}@{C}"] <= 1e-5, (name, S, n, C, err)
        assert int(counters.abs().sum()) == 0
        ms = {f"{n}@{C}": [] for n, C in runs}
        prev = []

        def previous():
            return PA.paged_decode_attention_previous(q, *next(kv), spt)
        for order in (runs, runs[::-1]):
            prev.append(cs.cuda_ms(previous, iters=20))
            for n, C in order:
                ms[f"{n}@{C}"].append(cs.cuda_ms(
                    lambda: call(C, libs[n]), iters=20))
        print(json.dumps(dict(
            case=name, S=S, rule=rule, ms={k: min(x) for k, x in ms.items()},
            previous_ms=min(prev), max_abs_err=err)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
