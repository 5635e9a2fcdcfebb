"""The port's DL models held against the JAX package's on the same
parameters (``convert.params_from_reference``) and inputs, on the CPU:
the tokenizers, ``TextEncoder`` (einsum and blockwise attention, padded
and fully masked rows, ``return_embeddings``), ResNet-18 with its batch
statistics, rematerialization and dropout.

Tolerances:

- tokenizer ids and masks: exact (the same pure-Python code);
- ``TextEncoder`` at f32: atol 1e-5 (both sides compute in f32; XLA's and
  PyTorch's CPU matmuls, softmax and LayerNorm reductions differ in the
  order of their sums, ~1e-7 per op over two layers);
- ``TextEncoder`` at bf16: atol = rtol = 2e-2 (every ``Dense``, the
  embeddings and the probabilities round to bf16, 2^-8 relative; where the
  two sides' f32 accumulations straddle a rounding boundary, an output
  moves by one bf16 ulp, ~1.6e-2 at the embeddings' magnitude);
- ResNet-18 at f32: logits and new ``batch_stats`` atol 1e-5 (f32
  convolutions and the BatchNorm statistics, E[x²] − E[x]² on both sides,
  summed in different orders); training with every block active 2e-4 (see
  ``test_resnet18_equals_jax``);
- rematerialization: gradients bitwise equal (the recompute re-runs the
  same ops on the same values, dropout masks included).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.models.dl import resnet as JR
from synapseml_tpu.models.dl import tokenizer as JTok
from synapseml_tpu.models.dl import transformer as JT
from synapseml_tpu_torch.models.dl import convert as C
from synapseml_tpu_torch.models.dl import resnet as PR
from synapseml_tpu_torch.models.dl import tokenizer as PTok
from synapseml_tpu_torch.models.dl import transformer as PT
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

CORPUS = ["the cat sat on the mat!", "dogs aren't cats, dogs are great",
          "a zebra's stripes", "unseen wordsmithing happens here",
          "cats and dogs and cats", "", "Mixed CASE Words?"]


# -- tokenizers ---------------------------------------------------------------

@pytest.mark.parametrize("vocab_size", [12, 64])
def test_word_tokenizer_ids_equal(vocab_size):
    """Fitted vocabulary, hash buckets for unseen words (vocab 12 forces
    them) and truncation at max_len give the JAX package's ids."""
    jt = JTok.WordTokenizer.fit(CORPUS[:5], vocab_size=vocab_size)
    pt = PTok.WordTokenizer.fit(CORPUS[:5], vocab_size=vocab_size)
    assert pt.to_dict() == jt.to_dict()
    for max_len in (4, 16):
        ji, jm = jt.encode(CORPUS, max_len)
        pi, pm = pt.encode(CORPUS, max_len)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pm, jm)
    assert pt.decode(pi) == jt.decode(ji)
    rt = PTok.tokenizer_from_dict(jt.to_dict())
    np.testing.assert_array_equal(rt.encode(CORPUS, 16)[0], ji)


def test_wordpiece_tokenizer_ids_equal(tmp_path):
    vocab = ["[PAD]", "[CLS]", "[SEP]", "[UNK]", "the", "cat", "dog", "##s",
             "un", "##seen", "##word", "word", "!", ",", "'", "a", "zebra",
             "##smith", "##ing", "t", "are", "great"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n")
    jt = JTok.WordPieceTokenizer.from_vocab_file(str(path))
    pt = PTok.WordPieceTokenizer.from_vocab_file(str(path))
    for max_len in (5, 24):
        ji, jm = jt.encode(CORPUS, max_len)
        pi, pm = pt.encode(CORPUS, max_len)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pm, jm)
    assert pt.decode(pi) == jt.decode(ji)
    assert isinstance(PTok.tokenizer_from_dict(jt.to_dict()),
                      PTok.WordPieceTokenizer)


# -- TextEncoder ----------------------------------------------------------------

B, S = 4, 24


def _text_inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1024, (B, S)).astype(np.int32)
    mask = np.ones((B, S), bool)
    mask[1, 10:] = False          # padded row
    mask[3] = False               # fully masked row (a padded tail chunk)
    return ids, mask


@pytest.fixture(scope="module", params=["f32", "bf16"])
def text_pair(request):
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[request.param]
    ids, mask = _text_inputs()
    jm = JT.TextEncoder(JT.TransformerConfig.tiny(dtype=jd))
    variables = jax.tree.map(np.asarray, nn.meta.unbox(
        jm.init(jax.random.PRNGKey(0), ids, mask)))
    out = {}
    for impl in ("einsum", "blockwise"):
        pcfg = PT.TransformerConfig.tiny(dtype=td, attention_impl=impl)
        pm = PT.TextEncoder(pcfg, device="cpu", seed=None)
        pm.load_state_dict(C.params_from_reference(variables, pcfg, "cpu"))
        out[impl] = pm
    jcfg = JT.TransformerConfig.tiny(dtype=jd, attention_impl="blockwise")
    jb = JT.TextEncoder(jcfg)
    ref = {"einsum": (jm.apply(variables, ids, mask),
                      jm.apply(variables, ids, mask, return_embeddings=True)),
           "blockwise": (jb.apply(variables, ids, mask),
                         jb.apply(variables, ids, mask,
                                  return_embeddings=True))}
    ref = {k: tuple(np.asarray(a).astype(np.float32) for a in v)
           for k, v in ref.items()}
    return request.param, variables, out, ref


def _tol(kind):
    return dict(atol=1e-5, rtol=0) if kind == "f32" else dict(atol=2e-2,
                                                              rtol=2e-2)


def test_conversion_keeps_every_text_parameter(text_pair):
    kind, variables, models, _ = text_pair
    leaves = jax.tree_util.tree_leaves(variables)
    pm = models["einsum"]
    assert sum(x.size for x in leaves) == sum(p.numel()
                                              for p in pm.parameters())
    for k, v in C.flatten_tree(variables["params"]).items():
        assert np.array_equal(pm.state_dict()[k].numpy(), v), k


@pytest.mark.parametrize("impl", ["einsum", "blockwise"])
@pytest.mark.parametrize("what", ["logits", "embeddings"])
def test_text_encoder_equals_jax(text_pair, impl, what):
    kind, _, models, ref = text_pair
    ids, mask = _text_inputs()
    with torch.no_grad():
        out = models[impl](torch.from_numpy(ids), torch.from_numpy(mask),
                           return_embeddings=(what == "embeddings"))
    want = ref[impl][0 if what == "logits" else 1]
    dt = torch.float32 if what == "logits" else models[impl].cfg.dtype
    assert out.dtype == dt
    np.testing.assert_allclose(out.float().numpy(), want, **_tol(kind))
    assert np.isfinite(out.float().numpy()).all()


def test_fully_masked_row_is_uniform_not_nan(text_pair):
    """The mask fills with f32's finite minimum: a row with no live key
    attends uniformly over its keys (every query gets the projected mean
    of the values) instead of dividing by zero."""
    kind, _, models, _ = text_pair
    m = models["einsum"]
    att = m.layer_0.attention
    with torch.no_grad():
        x = torch.randn(1, S, m.cfg.d_model).to(m.cfg.dtype)
        got = att(x, torch.zeros(1, S, dtype=torch.bool), None)
        want = att.out(att.value(x).float().mean(1, keepdim=True)
                       .to(m.cfg.dtype)).expand_as(got)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **_tol(kind))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_blockwise_attention_over_many_blocks(dtype):
    """The online-softmax scan over 8-wide K/V blocks (the last one padded)
    against the JAX package's scan and the port's einsum softmax."""
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 21, 2, 8
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, s), bool)
    mask[0, 15:] = False
    scale = 1.0 / np.sqrt(d)
    want = np.asarray(JT._blockwise_attention(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        jnp.asarray(mask), scale, 0.0, True, None, block_k=8)
    ).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    got = PT.blockwise_attention(tq, tk, tv, torch.from_numpy(mask), scale,
                                 0.0, None, block_k=8)
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(dtype))
    logits = torch.einsum("bqhd,bkhd->bhqk", tq.float(), tk.float()) * scale
    logits = logits.masked_fill(~torch.from_numpy(mask)[:, None, None],
                                PT.BIG_NEG)
    dense = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), tv.float())
    np.testing.assert_allclose(got.float().numpy(), dense.numpy(),
                               **_tol(dtype))


# -- ResNet ---------------------------------------------------------------------

@pytest.fixture(scope="module", params=[16, 17], ids=["even16", "odd17"])
def resnet_pair(request):
    size = request.param
    x = np.random.default_rng(size).normal(
        size=(4, size, size, 3)).astype(np.float32)
    jm = JR.make_backbone("resnet18", 3, dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), x,
                                                 train=False))
    # every block active: non-trivial statistics, scales (no block's last
    # norm at 0) and biases
    rng = np.random.default_rng(7)
    active = jax.tree.map(
        lambda a: (a + rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
                   if a.ndim == 1 else a), variables)
    return size, x, jm, {"init": variables, "active": active}


@pytest.mark.parametrize("train,which,atol", [
    (False, "init", 1e-5), (False, "active", 1e-5), (True, "init", 1e-5),
    (True, "active", 2e-4)],
    ids=["eval-init", "eval-active", "train-init", "train-active"])
def test_resnet18_equals_jax(resnet_pair, train, which, atol):
    """Logits and the new ``batch_stats``.  Training with every block
    active is held to 2e-4: the late stages normalize over 4 x 1 x 1
    values per channel, where E[x²] − E[x]² cancels and the two sides'
    orders of summation give variances that differ by ~1e-6 relative to
    E[x²] (on logits of magnitude ~6)."""
    size, x, jm, trees = resnet_pair
    variables = trees[which]
    pm = PR.make_backbone("resnet18", 3, dtype=torch.float32, device="cpu",
                          seed=None)
    pm.load_state_dict(C.params_from_reference(variables, "resnet18", "cpu"))
    if train:
        ref, upd = jm.apply(variables, x, train=True, mutable=["batch_stats"])
    else:
        ref = jm.apply(variables, x, train=False)
    with torch.no_grad():
        out = pm(torch.from_numpy(x), train=train)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol,
                               rtol=0)
    sd_before = {k: v.clone() for k, v in pm.state_dict().items()}
    pm.commit_batch_stats()
    sd = pm.state_dict()
    want = (C.flatten_tree(jax.tree.map(np.asarray, upd["batch_stats"]))
            if train else C.flatten_tree(variables["batch_stats"]))
    for k, v in want.items():
        np.testing.assert_allclose(sd[k].numpy(), v, atol=atol, rtol=0,
                                   err_msg=k)
        if not train:
            assert torch.equal(sd[k], sd_before[k])


def test_same_padding_is_flax_same():
    """flax "SAME": a stride-2 3x3 window over an even input pads (0, 1),
    over an odd one (1, 1); a 1x1 stride-2 window pads nothing."""
    assert PR.same_pads(16, 3, 2) == (0, 1)
    assert PR.same_pads(17, 3, 2) == (1, 1)
    assert PR.same_pads(112, 3, 2) == (0, 1)
    assert PR.same_pads(16, 1, 2) == (0, 0)
    assert PR.same_pads(7, 3, 1) == (1, 1)


def test_resnet_names_follow_the_flax_tree():
    pm = PR.make_backbone("resnet50", 10, device="cpu", seed=0)
    jm = JR.make_backbone("resnet50", 10)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    want = {k: tuple(v.shape) for coll in ("params", "batch_stats")
            for k, v in C.flatten_tree(shapes[coll]).items()}
    got = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert got == want
    # each block's last norm starts at scale 0
    assert not pm.BottleneckResNetBlock_0.BatchNorm_2.scale.detach().any()


# -- rematerialization and dropout ------------------------------------------------

def _grads(model, fn):
    model.zero_grad(set_to_none=True)
    fn().backward()
    return {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("policy", ["full", "dots_saveable"])
def test_text_remat_gradients_bitwise_equal(policy):
    ids, mask = _text_inputs()
    labels = torch.tensor([0, 1, 1, 0])
    grads = {}
    for remat in ("none", policy):
        cfg = PT.TransformerConfig.tiny(dtype=torch.float32, remat=remat,
                                        dropout_rate=0.1)
        m = PT.TextEncoder(cfg, device="cpu", seed=3)
        grads[remat] = _grads(m, lambda: torch.nn.functional.cross_entropy(
            m(torch.from_numpy(ids), torch.from_numpy(mask),
              deterministic=False, dropout_seed=11), labels))
    for k, g in grads["none"].items():
        assert torch.equal(g, grads[policy][k]), k


@pytest.mark.parametrize("policy", ["full", "dots_saveable"])
def test_resnet_remat_gradients_bitwise_equal(policy):
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4, 16, 16, 3)).astype(np.float32))
    labels = torch.tensor([0, 1, 2, 0])
    grads, stats = {}, {}
    for remat in ("none", policy):
        m = PR.make_backbone("resnet18", 3, dtype=torch.float32,
                             remat=remat, device="cpu", seed=4)
        grads[remat] = _grads(m, lambda: torch.nn.functional.cross_entropy(
            m(x, train=True), labels))
        m.commit_batch_stats()
        stats[remat] = {k: v.clone() for k, v in m.named_buffers()}
    for k, g in grads["none"].items():
        assert torch.equal(g, grads[policy][k]), k
    # the recomputed forward updates the batch statistics once
    for k, v in stats["none"].items():
        assert torch.equal(v, stats[policy][k]), k


def test_remat_policy_names():
    from synapseml_tpu_torch.models.dl.precision import remat_policy
    assert remat_policy("none") == (False, None)
    assert remat_policy(True)[0] and remat_policy("blocks") == (True, None)
    assert remat_policy("dots_saveable")[1] is not None
    with pytest.raises(ValueError):
        remat_policy("everything")


def test_dropout_masks_depend_on_seed_and_step_only():
    x = torch.ones(64, 256)
    a = PT.dropout(x, 0.1, PT.mix_seed(5, 3))
    b = PT.dropout(x, 0.1, PT.mix_seed(5, 3))
    c = PT.dropout(x, 0.1, PT.mix_seed(5, 4))
    d = PT.dropout(x, 0.1, PT.mix_seed(6, 3))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    assert PT.dropout(x, 0.1, None) is x


@pytest.mark.parametrize("total,ranks", [(16, 2), (24, 3), (32, 4),
                                         (48, 16), (34, 17), (96, 32)])
def test_dropout_rows_of_a_mesh_draw_the_whole_mask(total, ranks,
                                                    monkeypatch):
    """Each rank's rows (``rows=(lo, total)``) of the mask equal the
    one-process mask's, and a rank draws no more than the one process:
    one call of the whole batch."""
    x = torch.ones(total, 3, 5)
    whole = PT.dropout(x, 0.25, PT.mix_seed(7, 2))
    drawn = []
    rand = torch.rand

    def counted(*shape, **kw):
        out = rand(*shape, **kw)
        drawn.append(out.shape[0])
        return out

    monkeypatch.setattr(torch, "rand", counted)
    b = total // ranks
    for d in range(ranks):
        drawn.clear()
        part = PT.dropout(x[d * b:(d + 1) * b], 0.25, PT.mix_seed(7, 2),
                          rows=(d * b, total))
        assert torch.equal(part, whole[d * b:(d + 1) * b])
        assert drawn == [total]


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keeps_one_minus_rate(rate):
    n = 200_000
    out = PT.dropout(torch.ones(n), rate, PT.mix_seed(0, 1))
    kept = int((out != 0).sum())
    sigma = np.sqrt(n * rate * (1 - rate))
    assert abs(kept - n * (1 - rate)) < 3 * sigma
    # kept values are scaled by 1 / (1 - rate)
    np.testing.assert_allclose(out[out != 0].numpy(), 1.0 / (1 - rate),
                               rtol=1e-6)


def test_train_forward_draws_four_dropout_sites():
    """With dropout on, the step's forward differs from the eval forward,
    repeats exactly for the same seed, and changes with the seed."""
    cfg = PT.TransformerConfig.tiny(dtype=torch.float32, dropout_rate=0.3)
    m = PT.TextEncoder(cfg, device="cpu", seed=0)
    ids, mask = (torch.from_numpy(a) for a in _text_inputs())
    with torch.no_grad():
        ev = m(ids, mask)
        t1 = m(ids, mask, deterministic=False, dropout_seed=1)
        t1b = m(ids, mask, deterministic=False, dropout_seed=1)
        t2 = m(ids, mask, deterministic=False, dropout_seed=2)
    assert torch.equal(t1, t1b)
    assert not torch.equal(t1, ev) and not torch.equal(t1, t2)
    with pytest.raises(ValueError):
        m(ids, mask, deterministic=False)
