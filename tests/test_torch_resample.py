"""The port's resize (`io/resample.py`) against PIL 12's `Image.resize` with
its default filter, on the CPU: L, LA, RGB and RGBA at the resolution
ladder's factors (1/2, 1/4, 1/8, 1600/1920, 1600/2400), odd sizes, one
axis alone and upscales, bit for bit."""

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu_torch.data.cameras import pick_resolution
from gaussianmesh_tpu_torch.io.resample import coefficients, resize

torch.set_num_threads(2)

MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}
# (source w, h) -> target, as the ladder and odd callers ask
CASES = [((96, 64), (48, 32)), ((96, 64), (24, 16)), ((96, 64), (12, 8)),
         ((192, 108), (160, 90)), ((240, 160), (160, 106)), ((37, 23), (9, 5)),
         ((37, 23), (37, 11)), ((37, 23), (11, 23)), ((10, 7), (23, 13)),
         ((5, 3), (1, 1)), ((1700, 12), (1600, 11))]


def _image(w, h, c, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = (128 + 100 * np.sin(x[..., None] / 9.0 + np.arange(c)) * np.cos(y[..., None] / 13.0)
           + rng.normal(0, 30, (h, w, c)))
    img = np.clip(img, 0, 255).astype(np.uint8)
    if c in (2, 4):                     # fully clear and opaque pixels too
        u = rng.random((h, w))
        img[..., -1] = np.where(u < 0.2, 0, np.where(u < 0.5, 255, img[..., -1]))
    return img[..., 0] if c == 1 else img


@pytest.mark.parametrize("c", [1, 2, 3, 4], ids=lambda c: MODES[c])
@pytest.mark.parametrize("case", CASES, ids=lambda cs: f"{cs[0][0]}x{cs[0][1]}-{cs[1][0]}x{cs[1][1]}")
def test_resize_equals_pil(case, c):
    (w, h), size = case
    img = _image(w, h, c, seed=w * h + c)
    got = resize(img, size)
    want = np.asarray(Image.fromarray(img, MODES[c]).resize(size))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want), np.abs(got.astype(int) - want.astype(int)).max()


def test_resize_at_the_ladder_sizes():
    """-r -1 on 1920 and 2400 px wide images, -r 2 / 4 / 8 on a 4:3 one: the
    sizes `pick_resolution` gives, resized as PIL resizes them."""
    for (w, h), r in (((1920, 1080), -1), ((2400, 1600), -1), ((640, 480), 2),
                      ((640, 480), 4), ((640, 480), 8)):
        size = pick_resolution(w, h, r)
        img = _image(w, 8, 3, seed=r % 7)         # 8 rows: the width pass at full size
        got = resize(img, (size[0], 8))
        want = np.asarray(Image.fromarray(img).resize((size[0], 8)))
        assert np.array_equal(got, want), (w, h, r)
    assert pick_resolution(1920, 1080, -1) == (1600, 900)


def test_coefficients_sum_to_one_in_fixed_point():
    """Each output's weights sum to 2^22 within rounding, and none reaches
    past the source."""
    for n_in, n_out in ((1920, 1600), (64, 8), (7, 23), (5, 1)):
        xmin, k = coefficients(n_in, n_out)
        assert np.all(np.abs(k.sum(1) - (1 << 22)) <= k.shape[1])
        last = xmin + np.array([np.flatnonzero(r).max() for r in k])
        assert xmin.min() >= 0 and last.max() < n_in


def test_resize_rejects_what_pil_would_not_take():
    with pytest.raises(ValueError, match="uint8"):
        resize(np.zeros((4, 4), np.float32), (2, 2))
    with pytest.raises(ValueError, match="channels"):
        resize(np.zeros((4, 4, 5), np.uint8), (2, 2))
    img = _image(6, 4, 3, seed=0)
    assert resize(img, (6, 4)) is img
