"""The port's image ops and stages against the JAX package's, on the CPU.

Seeded (N, H, W, C) float32 batches go through ``synapseml_tpu.image``
and ``synapseml_tpu_torch.image`` (``device="cpu"``).  Tolerances:

- resize: within 1e-5 of the output's scale against ``jax.image.resize``
  itself (the weights are jax's, computed in float32; the contraction
  sums in another order);
- flip, threshold, crop and the rgb/bgr swap: equal; gray conversion and
  blur: within 1e-6 of scale (a three-term and a separable sum in
  another order);
- the stage chain: within 1e-5 of scale;
- SLIC: the labels are equal on these images; the centre update is a
  one-hot matmul whose float32 sums run in another order, so a pixel
  whose two nearest centres tie within a rounding step may flip, and the
  test holds the agreement to at least 0.999 for that reason.
"""

import jax
import numpy as np
import pytest
import torch

import synapseml_tpu.image as J
import synapseml_tpu_torch.image as T
from synapseml_tpu import Dataset as JDataset
from synapseml_tpu_torch.core import Dataset
from synapseml_tpu_torch.image import ops as TO
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def _batch(seed, shape=(2, 13, 17, 3)):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(
        np.float32)


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("out", [(2, 29, 40, 3), (2, 6, 5, 3),
                                 (2, 26, 8, 3)])
def test_resize_matches_jax_image_resize(method, antialias, out):
    x = _batch(0)
    want = np.asarray(jax.image.resize(x, out, method, antialias=antialias))
    got = TO.resize(torch.from_numpy(x), out, method, antialias).numpy()
    assert got.shape == want.shape
    assert _err(got, want) <= 1e-5


def test_resize_bilinear_matches_reference():
    x = _batch(1)
    want = np.asarray(J.resize_bilinear(x, 7, 30))
    got = T.resize_bilinear(torch.from_numpy(x), 7, 30).numpy()
    assert _err(got, want) <= 1e-5


def test_pixel_ops_match_reference():
    x = _batch(2)
    t = torch.from_numpy(x)
    for code in (0, 1, -1):
        np.testing.assert_array_equal(T.flip(t, code).numpy(),
                                      np.asarray(J.flip(x, code)))
    np.testing.assert_array_equal(T.threshold(t, 100.0, 255.0).numpy(),
                                  np.asarray(J.threshold(x, 100.0, 255.0)))
    np.testing.assert_array_equal(T.center_crop(t, 3, 2, 9, 7).numpy(),
                                  np.asarray(J.center_crop(x, 3, 2, 9, 7)))
    np.testing.assert_array_equal(T.color_convert(t, "bgr2rgb").numpy(),
                                  np.asarray(J.color_convert(x, "bgr2rgb")))
    assert _err(T.color_convert(t, "gray").numpy(),
                J.color_convert(x, "gray")) <= 1e-6
    for ap, sigma in ((5, 1.5), (7, 3.0), (3, 0.0)):
        assert _err(T.gaussian_blur(t, ap, sigma).numpy(),
                    J.gaussian_blur(x, ap, sigma)) <= 1e-6
    # an even aperture has 2 * (ap // 2) + 1 taps: both refuse it
    with pytest.raises(Exception):
        J.gaussian_blur(x, 4, 1.0)
    with pytest.raises(RuntimeError):
        T.gaussian_blur(t, 4, 1.0)
    np.testing.assert_array_equal(T.gaussian_kernel(7, 2.0),
                                  J.gaussian_kernel(7, 2.0))
    with pytest.raises(ValueError):
        T.color_convert(t, "hsv")
    with pytest.raises(ValueError):
        T.center_crop(t, 10, 0, 9, 7)


def _chain(IT, **kw):
    return (IT(inputCol="img", outputCol="out", **kw).resize(20, 24)
            .crop(2, 1, 18, 20).center_crop(16, 16).color_format("bgr2rgb")
            .blur(3, 1.0).gaussian_kernel(5, 2.0).flip(1).threshold(60.0)
            .normalize([0.1, 0.2, 0.3], [0.5, 0.6, 0.7], 1 / 255.0))


def test_image_transformer_chain_matches_reference():
    rng = np.random.default_rng(3)
    # two shapes and a grayscale image: three groups, one call each
    imgs = ([rng.uniform(0, 255, (13, 17, 3)).astype(np.float32)
             for _ in range(3)]
            + [rng.uniform(0, 255, (30, 25, 3)).astype(np.float32)]
            + [rng.uniform(0, 255, (21, 22)).astype(np.float32)])
    want = _chain(J.ImageTransformer).transform(JDataset({"img": imgs}))
    got = _chain(T.ImageTransformer, device="cpu").transform(
        Dataset({"img": imgs}))
    for w, g in zip(want["out"], got["out"]):
        assert g.dtype == np.float32 and g.shape == w.shape
        assert _err(g, w) <= 1e-5
    gray = (T.ImageTransformer(inputCol="img", outputCol="g", device="cpu")
            .color_format("gray").resize(8, 8).transform(
                Dataset({"img": imgs[:2]})))
    jgray = (J.ImageTransformer(inputCol="img", outputCol="g")
             .color_format("gray").resize(8, 8).transform(
                 JDataset({"img": imgs[:2]})))
    for w, g in zip(jgray["g"], gray["g"]):
        assert g.shape == (8, 8, 1) and _err(g, w) <= 1e-5


def test_unroll_and_augmenter_match_reference():
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 255, (5, 6, 3)).astype(np.uint8)
            for _ in range(3)]
    for JS, TS in ((J.UnrollImage, T.UnrollImage),
                   (J.UnrollBinaryImage, T.UnrollBinaryImage)):
        want = JS(inputCol="img").transform(JDataset({"img": imgs}))
        got = TS(inputCol="img").transform(Dataset({"img": imgs}))
        for w, g in zip(want["unrolled"], got["unrolled"]):
            np.testing.assert_array_equal(g, w)
    jaug = J.ImageSetAugmenter(inputCol="img", flipUpDown=True).transform(
        JDataset({"img": imgs, "k": np.arange(3)}))
    aug = T.ImageSetAugmenter(inputCol="img", flipUpDown=True,
                              device="cpu").transform(
        Dataset({"img": imgs, "k": np.arange(3)}))
    assert aug.num_rows == jaug.num_rows == 9
    np.testing.assert_array_equal(aug["k"], jaug["k"])
    for w, g in zip(jaug["augmented"], aug["augmented"]):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


def test_slic_segments_match_reference():
    rng = np.random.default_rng(5)
    # blocky images (four flat quadrants plus noise) and a noise image
    imgs = []
    for k in range(2):
        img = np.zeros((40, 48, 3), np.float32)
        img[:20, :24] = rng.uniform(0, 255, 3)
        img[:20, 24:] = rng.uniform(0, 255, 3)
        img[20:, :24] = rng.uniform(0, 255, 3)
        img[20:, 24:] = rng.uniform(0, 255, 3)
        imgs.append(img + rng.normal(0, 8, img.shape).astype(np.float32))
    imgs.append(rng.uniform(0, 255, (24, 30, 3)).astype(np.float32))
    agree = []
    for img in imgs:
        want = J.slic_segments(img, cell_size=8.0, modifier=40.0)
        got = T.slic_segments(img, cell_size=8.0, modifier=40.0,
                              device="cpu")
        assert got.dtype == np.int32 and got.shape == want.shape
        agree.append(float((got == want).mean()))
    assert min(agree) >= 0.999, agree
    ds = Dataset({"image": imgs[:1]})
    out = T.SuperpixelTransformer(inputCol="image", cellSize=8.0,
                                  modifier=40.0, device="cpu").transform(ds)
    np.testing.assert_array_equal(out["superpixels"][0], T.slic_segments(
        imgs[0], 8.0, 40.0, device="cpu"))
