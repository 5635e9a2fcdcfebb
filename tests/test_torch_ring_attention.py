"""Ring attention over a ``seq`` axis of gloo ranks held against the JAX
package's ``ring_attention`` on its 8 virtual devices, on the CPU.

One gang of 8 ranks (``data 2 x seq 4``) serves every case
(``tests/torch_gang_tasks.py:ring_cases``):

- ``tests/test_dl.py:36-52``'s shape (B 4, S 32, H 2, D 8, keys from 28
  masked) over data 2 x seq 4 on both sides;
- its long-sequence case (B 1, S 2048, H 2, D 16, keys from 1900
  masked): JAX runs data 1 x seq 8, the port seq 4 with the batch
  duplicated over its data axis of 2 (each data slice runs the same
  ring of 512 tokens a rank);
- the gradient of ``Σ out·w`` with respect to q, k and v against plain
  attention's (the port's einsum form, autograd, one process);
- ``TextEncoder(use_ring_attention=True)`` (tiny, f32, 32 tokens: 8 a
  rank) against the plain encoder on the whole sequence: embeddings and
  logits; and the same over ``dp_sp_tp_mesh(2, 2)`` (data 2 x seq 2 x
  model 2: the ring over 16-token blocks with the weights sharded over
  ``model`` too).

Tolerance 2e-5 absolute (the reference's own at 2048 tokens) on outputs
and gradients; 1e-5 on the encoder's embeddings and logits (f32, the
ring's online softmax against the einsum's).
"""

import os

import numpy as np
import pytest
import torch

from synapseml_tpu.models.dl.ring_attention import ring_attention as j_ring
from synapseml_tpu.parallel.mesh import make_mesh
from synapseml_tpu_torch.models.dl import transformer as PT
from synapseml_tpu_torch.models.dl.ring_attention import ring_attention
from synapseml_tpu_torch.parallel import run_on_local_cluster

import torch_gang_tasks as G
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

GANG_TIMEOUT_S = 240.0
ENC = dict(num_classes=3, dropout_rate=0.0)


def _case(seed, B, S, H, D, masked_from):
    rng = np.random.default_rng(seed)
    q, k, v = [rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(3)]
    mask = np.ones((B, S), bool)
    mask[:, masked_from:] = False
    w = rng.normal(size=(B, S, H, D)).astype(np.float32)
    return dict(q=q, k=k, v=v, mask=mask, w=w)


def _plain(z):
    """Full attention in one process with autograd → output and q/k/v
    gradients of ``Σ out·w``."""
    q, k, v = [torch.from_numpy(z[n]).requires_grad_(True)
               for n in ("q", "k", "v")]
    D = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(D)
    logits = logits.masked_fill(~torch.from_numpy(z["mask"])[:, None, None],
                                PT.BIG_NEG)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)
    (out * torch.from_numpy(z["w"])).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


class _Refs:
    def __init__(self, root):
        self.root = root
        self.z = {"short": _case(0, 4, 32, 2, 8, 28),
                  "long": _case(1, 1, 2048, 2, 16, 1900)}
        self.jax = {
            "short": np.asarray(j_ring(*[self.z["short"][n] for n in
                                         ("q", "k", "v", "mask")],
                                       make_mesh({"data": 2, "seq": 4}))),
            "long": np.asarray(j_ring(*[self.z["long"][n] for n in
                                        ("q", "k", "v", "mask")],
                                      make_mesh({"data": 1, "seq": 8})))}
        cases = {}
        for name, z in self.z.items():
            if name == "long":
                # the port's data axis of 2 runs the same ring twice
                z = {n: np.concatenate([a, a]) for n, a in z.items()}
            G._save_npz(self._p(f"{name}.npz"), z)
            cases[name] = dict(data=self._p(f"{name}.npz"),
                               out=self._p(f"{name}_out.npz"))
        enc = PT.TextEncoder(G._text_cfg(ENC), device="cpu", seed=5)
        G._save_npz(self._p("enc_init.npz"),
                    {k: v.numpy() for k, v in enc.state_dict().items()})
        rng = np.random.default_rng(2)
        ids = rng.integers(0, 1024, (2, 32)).astype(np.int32)
        mask = np.ones((2, 32), bool)
        mask[1, 20:] = False
        G._save_npz(self._p("enc_batch.npz"), dict(ids=ids, mask=mask))
        with torch.no_grad():
            self.enc = {"emb": enc(torch.from_numpy(ids),
                                   torch.from_numpy(mask),
                                   return_embeddings=True).numpy(),
                        "logits": enc(torch.from_numpy(ids),
                                      torch.from_numpy(mask)).numpy()}
        self.ranks = run_on_local_cluster(
            "torch_gang_tasks:ring_cases", 8,
            task_args=dict(device="cpu", data=2, cases=cases,
                           encoder=dict(cfg=ENC, init=self._p("enc_init.npz"),
                                        batch=self._p("enc_batch.npz"),
                                        out=self._p("enc_out.npz"))),
            device="cpu", timeout_s=GANG_TIMEOUT_S)
        self.port = {name: G._load_npz(c["out"]) for name, c in cases.items()}
        self.port["long"] = {n: a[:1] for n, a in self.port["long"].items()}
        self.port_enc = {n: G._load_npz(self._p(f"{n}_out.npz"))
                         for n in ("encoder", "encoder_tp")}

    def _p(self, name):
        return os.path.join(self.root, name)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return _Refs(str(tmp_path_factory.mktemp("ring")))


@pytest.mark.parametrize("name", ["short", "long"])
def test_ring_equals_jax_ring(refs, name):
    np.testing.assert_allclose(refs.port[name]["out"], refs.jax[name],
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", ["short", "long"])
def test_ring_gradients_equal_plain_attention(refs, name):
    """The ring's backward (K/V cotangents riding the ring the other way)
    gives plain attention's q, k and v gradients."""
    plain = _plain(refs.z[name])
    np.testing.assert_allclose(refs.port[name]["out"], plain["out"],
                               atol=2e-5, rtol=0)
    for n in ("dq", "dk", "dv"):
        np.testing.assert_allclose(refs.port[name][n], plain[n], atol=2e-5,
                                   rtol=0, err_msg=n)


@pytest.mark.parametrize("name", ["encoder", "encoder_tp"])
def test_text_encoder_with_ring_attention_equals_plain(refs, name):
    got = refs.port_enc[name]
    np.testing.assert_allclose(got["emb"], refs.enc["emb"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got["logits"], refs.enc["logits"], atol=1e-5,
                               rtol=0)


def test_ring_attention_needs_a_seq_axis():
    cfg = G._text_cfg(dict(ENC, use_ring_attention=True))
    with pytest.raises(ValueError, match="'seq' axis"):
        PT.TextEncoder(cfg, device="cpu")
    with pytest.raises(ValueError, match="'seq'"):
        ring_attention(*[torch.zeros(1, 4, 1, 2)] * 3, None, None)
