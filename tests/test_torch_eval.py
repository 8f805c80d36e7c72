"""The port's evaluation (`eval/lpips.py`, `eval/metrics.py`) against the JAX
package on the CPU: the LPIPS graph with the seed weights and with weights
converted from a torchvision-layout state dict, the seed weights
themselves, where the weights file is looked for, and `evaluate_dirs` /
`evaluate_model_paths` on the same PNG directories (keys, PSNR, SSIM,
LPIPS null with its note, LPIPS_uncalibrated)."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu.eval import lpips as jlpips, metrics as jmetrics
from gaussianmesh_tpu_torch.eval import lpips, metrics
from gaussianmesh_tpu_torch.io import png

torch.set_num_threads(2)


def _pair(h=35, w=33, seed=7):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def test_random_weights_are_the_jax_draws():
    mine, theirs = lpips.random_weights(0), jlpips.random_weights(0)
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert mine[k].dtype == np.float32
        assert np.array_equal(mine[k], np.asarray(theirs[k])), k
    assert not np.array_equal(lpips.random_weights(1)["conv0_w"], mine["conv0_w"])


def _torchvision_state(seed=3):
    """A VGG16 `features` state dict in torchvision's layout (conv layers at
    features.0, 2, 5, 7, 10, ...: indices past 9 sort wrongly as strings)
    and the LPIPS lins, seeded."""
    rng = np.random.default_rng(seed)
    vgg, idx, in_ch = {}, 0, 3
    for ch, n in lpips._VGG_CFG:
        for _ in range(n):
            vgg[f"features.{idx}.weight"] = torch.from_numpy(
                rng.normal(0, 0.05, (ch, in_ch, 3, 3)).astype(np.float32))
            vgg[f"features.{idx}.bias"] = torch.from_numpy(
                rng.normal(0, 0.01, ch).astype(np.float32))
            in_ch = ch
            idx += 2
        idx += 1                        # the max pool's slot
    lins = {f"lin{li}.model.1.weight": torch.from_numpy(
        rng.uniform(0, 0.1, (1, ch, 1, 1)).astype(np.float32))
        for li, (ch, _) in enumerate(lpips._VGG_CFG)}
    return vgg, lins


@pytest.mark.parametrize("weights", ["seed", "converted"])
def test_lpips_matches_jax(tmp_path, weights):
    """The port's LPIPS against `gaussianmesh_tpu.eval.lpips` within 1e-5
    relative on an odd size (the floor-mode max pools), and 0 for an image
    against itself."""
    a, b = _pair()
    if weights == "seed":
        mine = lpips.LPIPS(str(tmp_path / "absent.npz"), uncalibrated=True, device="cpu")
        theirs = jlpips.LPIPS(str(tmp_path / "absent.npz"), uncalibrated=True)
        assert not mine.calibrated and not theirs.calibrated
    else:
        vgg, lins = _torchvision_state()
        mine_npz, their_npz = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
        lpips.convert_torch_weights(vgg, lins, mine_npz)
        jlpips.convert_torch_weights(vgg, lins, their_npz)
        with np.load(mine_npz) as x, np.load(their_npz) as y:
            assert x.files == y.files
            assert all(np.array_equal(x[k], y[k]) for k in x.files)
            assert np.array_equal(x["conv4_w"], vgg["features.10.weight"].numpy())
        mine = lpips.LPIPS(mine_npz, device="cpu")
        theirs = jlpips.LPIPS(their_npz)
        assert mine.calibrated and theirs.calibrated
    got, want = mine(a, b), theirs(a, b)
    assert got > 0 and abs(got - want) <= 1e-5 * abs(want), (got, want)
    assert mine(a, a) == 0.0


def test_weights_path_follows_the_package(tmp_path, monkeypatch):
    """Fault B8: the JAX package looks at one absolute path; the port takes
    GM_TPU_LPIPS_WEIGHTS, else weights/lpips_vgg16.npz under the repository
    root found from its own file."""
    monkeypatch.delenv("GM_TPU_LPIPS_WEIGHTS", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(lpips.__file__)))
    assert lpips.default_weights_path() == os.path.join(
        os.path.dirname(root), "weights", "lpips_vgg16.npz")
    path = str(tmp_path / "w.npz")
    np.savez(path, **lpips.random_weights(0))
    monkeypatch.setenv("GM_TPU_LPIPS_WEIGHTS", path)
    assert lpips.default_weights_path() == path
    assert lpips.LPIPS(device="cpu").calibrated
    with pytest.raises(RuntimeError, match="weights"):
        lpips.LPIPS(str(tmp_path / "absent.npz"), device="cpu")(*_pair())


def _eval_dirs(root, n=3, h=24, w=32):
    """renders/ and gt/ PNGs: RGB renders; gt in RGB, RGBA and gray (the
    metric reads each as PIL's convert("RGB"))."""
    rng = np.random.default_rng(11)
    renders, gt = os.path.join(root, "renders"), os.path.join(root, "gt")
    os.makedirs(gt)
    for i in range(n):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        noisy = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
        png.write_png(os.path.join(renders, f"{i:05d}.png"), noisy)
        if i == 1:
            img = np.concatenate([img, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], -1)
        if i == 2:
            img = img[..., 0]
        Image.fromarray(img).save(os.path.join(gt, f"{i:05d}.png"))
    return renders, gt


@pytest.mark.parametrize("uncalibrated", [False, True])
def test_evaluate_dirs_matches_jax(tmp_path, uncalibrated):
    renders, gt = _eval_dirs(str(tmp_path))
    absent = str(tmp_path / "absent.npz")
    got = metrics.evaluate_dirs(renders, gt, absent, uncalibrated, device="cpu")
    want = jmetrics.evaluate_dirs(renders, gt, absent, uncalibrated)
    assert got["mean"].keys() == want["mean"].keys()
    assert got["mean"]["LPIPS"] is None and want["mean"]["LPIPS"] is None
    assert "LPIPS_note" in got["mean"]
    assert got["per_view"].keys() == want["per_view"].keys()
    for name, entry in want["per_view"].items():
        assert got["per_view"][name].keys() == entry.keys()
        for k, v in entry.items():
            assert abs(got["per_view"][name][k] - v) <= 1e-5 * max(1.0, abs(v)), (name, k)
    for k in ("SSIM", "PSNR") + (("LPIPS_uncalibrated",) if uncalibrated else ()):
        assert abs(got["mean"][k] - want["mean"][k]) <= 1e-5 * max(1.0, abs(want["mean"][k]))


def test_evaluate_model_paths_writes_the_jax_layout(tmp_path):
    """results.json and per_view.json under each model directory, keyed by
    method, with the JAX command line's keys and values within 1e-5."""
    out = {}
    for pkg, fn in (("port", lambda m: metrics.evaluate_model_paths(
            [m], str(tmp_path / "absent.npz"), True, device="cpu")),
                    ("jax", lambda m: jmetrics.evaluate_model_paths(
            [m], str(tmp_path / "absent.npz"), True))):
        model = str(tmp_path / pkg)
        _eval_dirs(os.path.join(model, "test", "ours_10"))
        fn(model)
        out[pkg] = [json.load(open(os.path.join(model, f)))
                    for f in ("results.json", "per_view.json")]
    (res, per_view), (jres, jper_view) = out["port"], out["jax"]
    assert res.keys() == jres.keys() == {"ours_10"}
    assert res["ours_10"].keys() == jres["ours_10"].keys()
    assert per_view["ours_10"].keys() == jper_view["ours_10"].keys()
    for k in ("PSNR", "SSIM", "LPIPS_uncalibrated"):
        assert abs(res["ours_10"][k] - jres["ours_10"][k]) <= 1e-5 * abs(jres["ours_10"][k])
    assert res["ours_10"]["LPIPS"] is None
