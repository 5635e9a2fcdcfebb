"""The port's msgpack reader held against the JAX package's on the CPU.

flax's serializer writes every file here; the port decodes it with its
own ``synapseml_tpu_torch.io.msgpack`` (no ``msgpack``, no ``flax``) and
``read_checkpoint`` must give the keys and the arrays (values and dtypes,
bit for bit) that the reference's ``read_checkpoint`` gives through
``flax.serialization.msgpack_restore``: every dtype, numpy and Python
scalars, nested and list-valued trees, chunked leaves, a sharded index
and the BERT / ResNet imports from a ``flax_model.msgpack``.
"""

import json

import flax.linen as nn
import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from synapseml_tpu.models.dl import checkpoints as JC
from synapseml_tpu.models.dl import estimators as JE
from synapseml_tpu.models.dl import resnet as JR
from synapseml_tpu_torch.io import msgpack as M
from synapseml_tpu_torch.models.dl import checkpoints as PC
from synapseml_tpu_torch.models.dl import convert as C
from synapseml_tpu_torch.models.dl import estimators as PE
from synapseml_tpu_torch.models.dl import resnet as PR
from synapseml_tpu_torch.models.dl import transformer as PT
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

DTYPES = ["float64", "float32", "float16", "bfloat16", "int8", "int16",
          "int32", "int64", "uint8", "uint16", "uint32", "uint64", "bool",
          "complex64", "complex128"]


def _array(rng, dtype, shape=(3, 4)):
    x = rng.normal(size=shape) * 100
    if dtype == "bool":
        return x > 0
    if dtype.startswith("complex"):
        return (x + 1j * rng.normal(size=shape)).astype(dtype)
    if dtype == "bfloat16":
        return np.asarray(jnp.asarray(x, jnp.bfloat16))
    if dtype.startswith("u"):
        return np.abs(x).astype(dtype)
    return x.astype(dtype)


def _write(path, tree):
    path.write_bytes(fser.msgpack_serialize(tree))
    return str(path)


def _assert_same(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if got[k].dtype.kind in "fc":       # bit patterns, NaN signs too
            assert got[k].tobytes() == want[k].tobytes(), k


def _nest(flat):
    """``{"a.b.c": x}`` → ``{"a": {"b": {"c": x}}}``."""
    out = {}
    for k, v in flat.items():
        node = out
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_dtype_reads_as_the_reference(tmp_path, dtype):
    rng = np.random.default_rng(DTYPES.index(dtype))
    tree = {"params": {"w": _array(rng, dtype),
                       "empty": _array(rng, dtype, (0, 3)),
                       "scalar_array": _array(rng, dtype, ())},
            "np_scalar": _array(rng, dtype, ())[()]}
    path = _write(tmp_path / "m.msgpack", tree)
    _assert_same(PC.read_checkpoint(path), JC.read_checkpoint(path))


def test_special_floats_and_python_leaves(tmp_path):
    f = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, 3.4e38],
                 np.float32)
    tree = {"f32": f, "f64": f.astype(np.float64),
            "bf16": np.asarray(jnp.asarray(f, jnp.bfloat16)),
            "int": 7, "neg": -3, "big": 2 ** 62, "huge": 2 ** 64 - 1,
            "small_neg": -2 ** 63, "float": 1.25, "true": True,
            "false": False, "text": "héllo", "complex": 1.5 - 2j,
            "none": None, "bytes": b"\x00\x01raw"}
    path = _write(tmp_path / "m.msgpack", tree)
    got, want = PC.read_checkpoint(path), JC.read_checkpoint(path)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if want[k].dtype == object:
            assert got[k].item() == want[k].item(), k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].tobytes() == want[k].tobytes(), k


def test_nested_and_list_valued_trees(tmp_path):
    rng = np.random.default_rng(3)
    tree = {"encoder": {"layer": {str(i): {"kernel": _array(rng, "float32"),
                                           "bias": _array(rng, "float32",
                                                          (4,))}
                                  for i in range(12)},
                        "shape": [3, 4, 5],
                        "stack": [_array(rng, "float32", (2,)),
                                  _array(rng, "float32", (2,))],
                        "bf_stack": [_array(rng, "bfloat16", (2,))] * 3,
                        "pair": [1.5, 2.5],
                        "deep": {"a": {"b": {"c": {"d": np.arange(40)}}}}},
            # 16+ keys and 16+ elements switch to map16 / array16
            "wide": {f"k{i}": i for i in range(40)},
            "long": list(range(300)),
            "long_str": "x" * 70000}
    path = _write(tmp_path / "m.msgpack", tree)
    _assert_same(PC.read_checkpoint(path), JC.read_checkpoint(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_chunked_leaves_rejoin(tmp_path, monkeypatch, dtype):
    """flax splits a leaf over ``MAX_CHUNK_SIZE`` bytes into a
    ``__msgpack_chunked_array__`` dict; both readers rejoin it."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(4)
    tree = {"big": _array(rng, dtype, (7, 9, 5)),
            "inner": {"big": _array(rng, dtype, (67,)),
                      "small": _array(rng, dtype, (2,))}}
    raw = fser.msgpack_serialize(tree)
    assert raw.count(M.CHUNKED_KEY.encode()) == 2
    path = tmp_path / "m.msgpack"
    path.write_bytes(raw)
    got = PC.read_checkpoint(str(path))
    _assert_same(got, JC.read_checkpoint(str(path)))
    want = tree["big"].astype(np.float32) if dtype == "bfloat16" \
        else tree["big"]
    np.testing.assert_array_equal(got["big"], want)


def test_sharded_index_of_msgpack_files(tmp_path):
    rng = np.random.default_rng(5)
    flat = {f"layer.{i}.{n}": _array(rng, "float32", (3, 2))
            for i in range(4) for n in ("weight", "bias")}
    names = sorted(flat)
    shards = {"a.msgpack": names[::2], "b.msgpack": names[1::2]}
    for f, keys in shards.items():
        _write(tmp_path / f, _nest({k: flat[k] for k in keys}))
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {k: f for f, ks in shards.items() for k in ks}}))
    got, want = PC.read_checkpoint(str(tmp_path)), JC.read_checkpoint(
        str(tmp_path))
    assert set(got) == set(want) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], flat[k])


def test_malformed_files_raise(tmp_path):
    good = fser.msgpack_serialize({"w": np.arange(4, dtype=np.float32)})
    for name, raw in (("trunc", good[:-3]), ("trailing", good + b"\x00"),
                      ("reserved", b"\xc1"),
                      ("ext", b"\xd4\x07\x00")):
        path = tmp_path / f"{name}.msgpack"
        path.write_bytes(raw)
        with pytest.raises(ValueError, match="msgpack"):
            PC.read_checkpoint(str(path))


def _zeros_like_init(module, x):
    """The module's variables as zeros of their shapes (the imports
    overwrite every leaf they map; nothing needs the random init)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                        nn.meta.unbox(shapes))


def test_import_bert_from_msgpack_equals_jax(tmp_path):
    from test_torch_dl_estimators import VOCAB, _hf_bert
    w, cfg = _hf_bert(np.random.default_rng(0), len(VOCAB))
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    _write(tmp_path / "flax_model.msgpack", _nest(w))
    d = str(tmp_path)
    assert set(PC.read_checkpoint(d)) == set(w)
    _, jcfg = JE._bert_checkpoint_assets(d, 0.0)
    _, pcfg = PE._bert_checkpoint_assets(d, 0.0)
    params = _zeros_like_init(JE.TextEncoder(jcfg),
                              np.ones((1, 4), np.int32))["params"]
    want = jax.tree.map(np.asarray, nn.meta.unbox(
        JC.import_bert(params, d, jcfg.num_layers)))
    pm = PT.TextEncoder(pcfg, device="cpu", seed=0)
    got = PC.import_bert(pm.state_dict(), d, pcfg.num_layers)
    for k, v in C.flatten_tree(want).items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def _torchvision_resnet18(rng, f, classes):
    """A torchvision-named resnet18 state dict at width ``f``."""
    w = {}

    def conv(name, cout, cin, k):
        w[name] = (rng.normal(size=(cout, cin, k, k)) * 0.1).astype(
            np.float32)

    def bn(name, c):
        w[name + ".weight"] = (1 + rng.normal(size=c) * 0.1).astype(
            np.float32)
        w[name + ".bias"] = rng.normal(size=c).astype(np.float32)
        w[name + ".running_mean"] = rng.normal(size=c).astype(np.float32)
        w[name + ".running_var"] = rng.uniform(0.5, 2, size=c).astype(
            np.float32)
        w[name + ".num_batches_tracked"] = np.array(7, np.int64)

    conv("conv1.weight", f, 3, 7)
    bn("bn1", f)
    cin = f
    for s in range(4):
        cout = f * 2 ** s
        for j in range(2):
            p = f"layer{s + 1}.{j}"
            conv(p + ".conv1.weight", cout, cin, 3)
            bn(p + ".bn1", cout)
            conv(p + ".conv2.weight", cout, cout, 3)
            bn(p + ".bn2", cout)
            if j == 0 and s > 0:
                conv(p + ".downsample.0.weight", cout, cin, 1)
                bn(p + ".downsample.1", cout)
            cin = cout
    w["fc.weight"] = rng.normal(size=(classes, cin)).astype(np.float32)
    w["fc.bias"] = rng.normal(size=classes).astype(np.float32)
    return w


def test_import_resnet_from_msgpack_equals_jax(tmp_path):
    f, classes = 8, 3
    tv = _torchvision_resnet18(np.random.default_rng(1), f, classes)
    _write(tmp_path / "flax_model.msgpack", _nest(tv))
    d = str(tmp_path)
    jnet = JR.make_backbone("resnet18", classes, num_filters=f)
    jvars = _zeros_like_init(jnet, np.ones((1, 16, 16, 3), np.float32))
    want = jax.tree.map(np.asarray, nn.meta.unbox(JC.import_resnet(
        dict(jvars), d, stage_sizes=[2, 2, 2, 2], bottleneck=False)))
    pnet = PR.make_backbone("resnet18", classes, num_filters=f,
                            device="cpu", seed=0)
    got = PC.import_resnet(pnet.state_dict(), d, stage_sizes=[2, 2, 2, 2],
                           bottleneck=False)
    for coll in ("params", "batch_stats"):
        for k, v in C.flatten_tree(want[coll]).items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    np.testing.assert_array_equal(got["head.kernel"].numpy(),
                                  tv["fc.weight"].T)

