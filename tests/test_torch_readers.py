"""The port's dataset IO against the JAX package on the CPU: the PNG codec
against PIL, COLMAP models, the Blender and COLMAP scene readers, the
scene's camera order and the uint8 training targets."""

import json
import os
import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from PIL import Image

from gaussianmesh_tpu.data import readers as jreaders
from gaussianmesh_tpu.io import colmap as jcolmap, ply as jply_io
from gaussianmesh_tpu.scene import Scene as JScene
from gaussianmesh_tpu.config import ModelParams as JModelParams
from gaussianmesh_tpu.train import trainer as jtrainer
from gaussianmesh_tpu_torch.config import ModelParams
from gaussianmesh_tpu_torch.data import cameras, readers
from gaussianmesh_tpu_torch.io import colmap, png
from gaussianmesh_tpu_torch.scene import Scene
from gaussianmesh_tpu_torch.train.trainer import DeviceDataset

torch.set_num_threads(2)

MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))


def _encode(img, filters, interlace=0, depth=8):
    """A PNG of `img` (uint8, or uint16 at depth 16) whose row y of each
    pass uses filter filters[y % len]: a plain numpy encoder, so every
    filter type, 16-bit samples and Adam7 are exercised."""
    img3 = img[..., None] if img.ndim == 2 else img
    h, w, c = img3.shape
    bpp = c * depth // 8
    rows = []
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = img3[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        sub = sub.astype(">u2").view(np.uint8) if depth == 16 else sub
        x = sub.reshape(sub.shape[0], -1).astype(np.int32)
        for y in range(x.shape[0]):
            f = filters[y % len(filters)]
            row = x[y]
            up = x[y - 1] if y else np.zeros_like(row)
            left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
            ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
            pred = [0, left, up, (left + up) // 2, paeth][f]
            rows.append(bytes([f]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes())
    ct = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (png.PNG_MAGIC
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ct, 0, 0, interlace))
            + _chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + _chunk(b"IEND", b""))


def _image(c, h=13, w=17, seed=0):
    """Noise plus a smooth ramp (so PIL's and imageio's adaptive filters
    pick more than one type)."""
    rng = np.random.default_rng(seed + c)
    y, x = np.mgrid[0:h, 0:w]
    base = (3 * x + 5 * y)[..., None] + 40 * np.arange(c)
    img = (base + rng.integers(0, 4, (h, w, c))) % 256
    return img[..., 0].astype(np.uint8) if c == 1 else img.astype(np.uint8)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_png_decodes_every_filter_as_pil(tmp_path, c):
    """Gray, gray + alpha, RGB, RGBA; filters 0-4 alone and mixed; and the
    PNGs PIL and imageio write: the same array as PIL's, shape and dtype."""
    img = _image(c)
    path = str(tmp_path / "x.png")
    for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4], [4, 3, 2, 1, 0, 2]):
        with open(path, "wb") as fh:
            fh.write(_encode(img, filters))
        got, want = png.read_png(path), np.asarray(Image.open(path))
        assert got.dtype == want.dtype and got.shape == want.shape, filters
        assert np.array_equal(got, want) and np.array_equal(got, img), filters
    for write in (lambda p: Image.fromarray(img, MODES[c]).save(p),
                  lambda p: imageio.imwrite(p, img)):
        write(path)
        assert np.array_equal(png.read_png(path), np.asarray(Image.open(path)))
    png.write_png(path, img)
    assert np.array_equal(np.asarray(Image.open(path)), img)
    assert np.array_equal(png.read_png(path), img)


def test_unsupported_images_raise(tmp_path):
    """What PIL would not read either raises with a message naming the
    cause: a bit depth the color type does not allow, a palette PNG without
    its palette, a file of no format the port reads (a JPEG 2000 file),
    a lossless JPEG (SOF3)."""
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as fh:
        fh.write(png.PNG_MAGIC
                 + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 4, 2, 0, 0, 0))
                 + _chunk(b"IDAT", zlib.compress(bytes(4 * 7)))
                 + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="4-bit samples"):
        png.read_png(bad)
    pal = str(tmp_path / "p.png")
    Image.fromarray(_image(3)).convert("P").save(pal)
    data = open(pal, "rb").read()
    i = data.index(b"PLTE") - 4
    with open(pal, "wb") as fh:
        fh.write(data[:i] + data[i + 12 + struct.unpack(">I", data[i:i + 4])[0]:])
    with pytest.raises(ValueError, match="PLTE"):
        png.read_png(pal)
    other = str(tmp_path / "x.jp2")
    Image.fromarray(_image(3)).save(other, "JPEG2000")
    assert Image.open(other).format == "JPEG2000"
    with pytest.raises(ValueError, match="not a JPEG, PNG, BMP, TIFF, GIF, WebP, PNM, QOI, "
                                         "SGI, PCX, DIB, ICO, CUR, DCX, ICNS, MSP, PSD, SUN, "
                                         "XBM, XPM, FLI, GBR, IM, IMT, IPTC, PIXAR, MCIDAS, "
                                         "XVTHUMB, FITS, FTEX, DDS, BLP or TGA"):
        png.read_image(other)
    lossless = str(tmp_path / "l.jpg")
    Image.fromarray(_image(3)).save(lossless)
    data = open(lossless, "rb").read()
    with open(lossless, "wb") as fh:
        fh.write(data.replace(b"\xff\xc0", b"\xff\xc3", 1))
    with pytest.raises(ValueError, match="lossless"):
        png.read_image(lossless)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_png_16_bit_keeps_the_high_byte(tmp_path, c):
    """16-bit PNGs: PIL gives RGB(A) their high bytes and opens gray + alpha
    as RGBA of the high bytes; gray comes back from PIL unscaled (values up
    to 65,535, fault B7), and the port keeps its high byte too. Filters 0-4
    over two-byte samples."""
    rng = np.random.default_rng(c)
    img = rng.integers(0, 1 << 16, (11, 9, c), dtype=np.uint16)
    img = img[..., 0] if c == 1 else img
    path = str(tmp_path / "x16.png")
    with open(path, "wb") as fh:
        fh.write(_encode(img, [0, 1, 2, 3, 4], depth=16))
    got = png.read_png(path)
    want = np.asarray(Image.open(path))
    if c == 1:
        assert want.max() > 255           # B7: the JAX reader's PIL path
        want = (want.astype(np.int64) >> 8).astype(np.uint8)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    high = (img >> 8).astype(np.uint8)
    assert np.array_equal(got, high[..., [0, 0, 0, 1]] if c == 2 else high)
    if c == 1:                            # PIL's own 16-bit gray writer
        Image.fromarray(img).save(path)
        assert np.array_equal(png.read_png(path), high)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("trns", [False, True])
def test_palette_png_expands_as_pil_convert(tmp_path, bits, trns):
    """Palette PNGs (fault B6: the JAX reader takes the indices) expand to
    RGB, or to RGBA where a tRNS chunk gives alpha, as PIL's convert."""
    rng = np.random.default_rng(bits)
    n = 1 << bits
    idx = rng.integers(0, n, (13, 21), dtype=np.uint8)
    im = Image.fromarray(idx, "P")
    im.putpalette(rng.integers(0, 256, 3 * n, dtype=np.uint8).tobytes())
    path = str(tmp_path / "p.png")
    kw = {"bits": bits} if bits < 8 else {}
    if trns:
        kw["transparency"] = rng.integers(0, 256, max(1, n // 2), dtype=np.uint8).tobytes()
    im.save(path, **kw)
    back = Image.open(path)
    assert back.mode == "P" and np.array_equal(np.asarray(back), idx)
    want = np.asarray(back.convert("RGBA" if trns else "RGB"))
    got = png.read_png(path)
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_adam7_interlaced_png_as_pil(tmp_path, c):
    """Adam7 passes at sizes where some passes are empty, each pass's rows
    with all five filters; and 1-bit gray, interlaced and not."""
    for h, w in ((13, 17), (1, 1), (3, 2), (9, 8)):
        img = _image(c, h=h, w=w, seed=h * w)
        path = str(tmp_path / f"i{h}x{w}.png")
        with open(path, "wb") as fh:
            fh.write(_encode(img, [0, 1, 2, 3, 4], interlace=1))
        want = np.asarray(Image.open(path))
        got = png.read_png(path)
        assert np.array_equal(got, want) and np.array_equal(got, img), (h, w)
    if c == 1:
        bw = np.random.default_rng(0).random((13, 17)) < 0.5
        path = str(tmp_path / "b.png")
        Image.fromarray(bw).save(path)
        assert np.array_equal(png.read_png(path), np.asarray(Image.open(path).convert("L")))


# ------------------------------------------------------------------ COLMAP
def _colmap_model(rng, n_img=5, n_pts=40):
    cams = {1: jcolmap.ColmapCamera(1, "PINHOLE", 40, 30,
                                    np.array([35.0, 33.0, 20.0, 15.0])),
            2: jcolmap.ColmapCamera(2, "SIMPLE_PINHOLE", 40, 30,
                                    np.array([31.0, 20.0, 15.0]))}
    imgs = {}
    for i in range(1, n_img + 1):
        q = rng.normal(size=4)
        imgs[i] = jcolmap.ColmapImage(i, q / np.linalg.norm(q), rng.normal(size=3),
                                      1 + i % 2, f"im{i:03d}.png")
    xyz = rng.normal(size=(n_pts, 3))
    rgb = rng.integers(0, 256, (n_pts, 3))
    err = rng.uniform(0, 1, n_pts)
    return cams, imgs, xyz, rgb, err


def _write_text(sparse, cams, imgs, xyz, rgb, err):
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.txt"), "w") as fh:
        fh.write("# cameras\n")
        for c in cams.values():
            fh.write(f"{c.id} {c.model} {c.width} {c.height} "
                     + " ".join(repr(float(p)) for p in c.params) + "\n")
    with open(os.path.join(sparse, "images.txt"), "w") as fh:
        fh.write("# images\n")
        for im in imgs.values():
            fh.write(f"{im.id} " + " ".join(repr(float(x)) for x in im.qvec) + " "
                     + " ".join(repr(float(x)) for x in im.tvec)
                     + f" {im.camera_id} {im.name}\n\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as fh:
        for i in range(len(xyz)):
            fh.write(f"{i} " + " ".join(repr(float(x)) for x in xyz[i]) + " "
                     + " ".join(str(int(x)) for x in rgb[i]) + f" {float(err[i])!r}\n")


def _assert_colmap_equal(a, b):
    (ca, ia, pa), (cb, ib, pb) = a, b
    assert ca.keys() == cb.keys() and ia.keys() == ib.keys()
    for k in ca:
        assert (ca[k].model, ca[k].width, ca[k].height) == \
            (cb[k].model, cb[k].width, cb[k].height)
        assert np.array_equal(ca[k].params, cb[k].params)
    for k in ia:
        assert (ia[k].name, ia[k].camera_id) == (ib[k].name, ib[k].camera_id)
        assert np.array_equal(ia[k].qvec, ib[k].qvec)
        assert np.array_equal(ia[k].tvec, ib[k].tvec)
    for x, y in zip(pa, pb):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("kind", ["binary", "text"])
def test_colmap_model_round_trip_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(1)
    cams, imgs, xyz, rgb, err = _colmap_model(rng)
    sparse = str(tmp_path / "sparse")
    if kind == "binary":
        colmap.write_model_binary(sparse, {k: colmap.ColmapCamera(**vars(c))
                                           for k, c in cams.items()},
                                  {k: colmap.ColmapImage(**vars(i))
                                   for k, i in imgs.items()}, xyz, rgb, err)
    else:
        _write_text(sparse, cams, imgs, xyz, rgb, err)
    got, want = colmap.read_model(sparse), jcolmap.read_model(sparse)
    _assert_colmap_equal(got, want)
    np.testing.assert_array_equal(got[2][0], xyz)
    np.testing.assert_array_equal(got[1][3].qvec, imgs[3].qvec)


# ------------------------------------------------------------------ scenes
def _rotation(rng):
    return np.linalg.qr(rng.normal(size=(3, 3)))[0]


def _blender_set(root, with_ply, w=24, h=20, n=4):
    """RGBA frames written by PIL, random poses; test split = 2 frames."""
    root = str(root)
    rng = np.random.default_rng(2)
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    frames = []
    for i in range(n):
        img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        img[..., 3] = np.where(rng.uniform(size=(h, w)) < 0.3, 255, img[..., 3])
        Image.fromarray(img, "RGBA").save(os.path.join(root, "train", f"r_{i}.png"))
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = _rotation(rng), rng.normal(0, 3, 3)
        frames.append({"file_path": f"train/r_{i}", "transform_matrix": c2w.tolist()})
    for split, fr in (("train", frames), ("test", frames[1:3])):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as fh:
            json.dump({"camera_angle_x": 0.7, "frames": fr}, fh)
    if with_ply:
        pts = rng.normal(size=(50, 3)).astype(np.float32)
        rgb = rng.integers(0, 256, (50, 3)).astype(np.uint8)
        jply_io.write_ply(os.path.join(root, "points3d.ply"), {"vertex": {
            "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
            "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2]}})
    return root


def _colmap_set(root, n=9):
    """A COLMAP scene: binary model, RGB PNG images (imageio), masks as
    gray PNGs and, for one image, an RGB mask (its first channel counts)."""
    root = str(root)
    rng = np.random.default_rng(3)
    cams, imgs, xyz, rgb, err = _colmap_model(rng, n_img=n, n_pts=60)
    for d in ("images", "masks"):
        os.makedirs(os.path.join(root, d))
    for im in imgs.values():
        imageio.imwrite(os.path.join(root, "images", im.name),
                        rng.integers(0, 256, (30, 40, 3), dtype=np.uint8))
        mask = rng.integers(0, 256, (30, 40) if im.id != 2 else (30, 40, 3),
                            dtype=np.uint8)
        Image.fromarray(mask).save(os.path.join(root, "masks", im.name))
    colmap.write_model_binary(os.path.join(root, "sparse", "0"),
                              {k: colmap.ColmapCamera(**vars(c)) for k, c in cams.items()},
                              {k: colmap.ColmapImage(**vars(i)) for k, i in imgs.items()},
                              xyz, rgb, err)
    return root


def _assert_scene_equal(got, want):
    for split in ("train_cameras", "test_cameras"):
        a, b = getattr(got, split), getattr(want, split)
        assert len(a) == len(b) > 0, split
        for ca, cb in zip(a, b):
            assert (ca.uid, ca.image_name, ca.width, ca.height) == \
                (cb.uid, cb.image_name, cb.width, cb.height)
            assert ca.fovx == cb.fovx and ca.fovy == cb.fovy
            for k in ("R", "T", "image"):
                x, y = getattr(ca, k), getattr(cb, k)
                assert x.dtype == y.dtype and np.array_equal(x, y), k
            assert (ca.mask is None) == (cb.mask is None)
            if ca.mask is not None:
                assert ca.mask.dtype == cb.mask.dtype
                assert np.array_equal(ca.mask, cb.mask)
    assert np.array_equal(got.nerf_norm["translate"], want.nerf_norm["translate"])
    assert got.nerf_norm["radius"] == want.nerf_norm["radius"]
    for k in ("points", "colors", "normals"):
        x, y = getattr(got.point_cloud, k), getattr(want.point_cloud, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    assert got.ply_path == want.ply_path


@pytest.mark.parametrize("kind", ["blender", "blender_no_ply", "colmap"])
def test_read_scene_matches_jax(tmp_path, kind):
    """Cameras (R, T, fov), images and masks exactly, with their dtypes (a
    Blender RGBA image composited over the float64 background is float64),
    the nerf++ normalization and the point cloud (the 100,000 seeded points
    where a Blender set has no points3d.ply); the uint8 targets of
    `DeviceDataset` equal the JAX package's."""
    if kind == "colmap":
        root = _colmap_set(tmp_path / "c")
        kw = dict(eval_split=True, is_exist_bg=True)
    else:
        root = _blender_set(tmp_path / "b", with_ply=kind == "blender")
        kw = dict(eval_split=True, white_background=kind == "blender")
    assert readers.detect_scene_type(root) == kind.split("_")[0]
    got, want = readers.read_scene(root, **kw), jreaders.read_scene(root, **kw)
    _assert_scene_equal(got, want)
    if kind == "blender":
        assert got.train_cameras[0].image.dtype == np.float64
    if kind == "blender_no_ply":
        assert got.point_cloud.points.shape == (100_000, 3)
    dt = DeviceDataset.from_cameras(got.train_cameras, device="cpu")
    dj = jtrainer.DeviceDataset.from_cameras(want.train_cameras)
    for k in ("images", "masks"):
        x, y = getattr(dt, k).numpy(), np.asarray(getattr(dj, k))
        assert x.dtype == y.dtype == np.uint8 and np.array_equal(x, y), k


def _jpeg_colmap_set(root, w=1700, h=22, n=6):
    """A COLMAP scene of JPEG images (PIL, quality 90, 4:2:0 / 4:2:2 /
    4:4:4 in turn, one gray) `w` px wide, and masks at half the image size:
    gray PNGs and, for one image, an RGB one."""
    root = str(root)
    rng = np.random.default_rng(4)
    cams, imgs, xyz, rgb, err = _colmap_model(rng, n_img=n, n_pts=30)
    for d in ("images", "masks"):
        os.makedirs(os.path.join(root, d))
    renamed = {}
    y, x = np.mgrid[0:h, 0:w]
    for im in imgs.values():
        name = im.name.replace(".png", ".jpg")
        renamed[im.id] = colmap.ColmapImage(im.id, im.qvec, im.tvec, im.camera_id, name)
        img = np.clip(128 + 90 * np.sin(x[..., None] / (20.0 + im.id) + np.arange(3))
                      + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
        if im.id == 3:
            Image.fromarray(img[..., 0]).save(os.path.join(root, "images", name), quality=90)
        else:
            Image.fromarray(img).save(os.path.join(root, "images", name), quality=90,
                                      subsampling=im.id % 3)
        mask = rng.integers(0, 256, (h // 2, w // 2) if im.id != 2 else (h // 2, w // 2, 3),
                            dtype=np.uint8)
        Image.fromarray(mask).save(os.path.join(root, "masks", name.replace(".jpg", ".png")))
    colmap.write_model_binary(os.path.join(root, "sparse", "0"),
                              {k: colmap.ColmapCamera(**vars(c)) for k, c in cams.items()},
                              renamed, xyz, rgb, err)
    return root


@pytest.mark.parametrize("resolution", [1, 2, -1])
def test_jpeg_colmap_scene_on_the_ladder_matches_jax(tmp_path, resolution):
    """JPEG images 1,700 px wide with masks at half their size: at -r 1 the
    masks are upscaled to the images, at -r 2 both are halved, at -r -1 the
    images go to 1,600 px; images, masks and cameras equal the JAX reader's
    (PIL's decoder and bicubic resize) bit for bit, a gray JPEG repeated to
    3 channels."""
    root = _jpeg_colmap_set(tmp_path / "c")
    kw = dict(resolution=resolution, eval_split=True, is_exist_bg=True)
    got, want = readers.read_scene(root, **kw), jreaders.read_scene(root, **kw)
    _assert_scene_equal(got, want)
    cam = got.train_cameras[0]
    assert cam.image.shape[1:] == {1: (22, 1700), 2: (11, 850), -1: (20, 1600)}[resolution]
    assert cam.mask.shape[1:] == cam.image.shape[1:]


@pytest.mark.parametrize("resolution", [2, 4])
def test_blender_rgba_scene_resized_matches_jax(tmp_path, resolution):
    """A Blender set's RGBA frames at -r 2 and 4: resized premultiplied by
    alpha as PIL does, then composited over the background, equal to the
    JAX reader's."""
    root = _blender_set(tmp_path / "b", with_ply=True, w=40, h=28)
    kw = dict(resolution=resolution, white_background=True, eval_split=True)
    got, want = readers.read_scene(root, **kw), jreaders.read_scene(root, **kw)
    _assert_scene_equal(got, want)
    assert got.train_cameras[0].image.shape == (3, 28 // resolution, 40 // resolution)


def test_colmap_without_masks_raises_for_a_background_run(tmp_path):
    root = _colmap_set(tmp_path / "c")
    os.rename(os.path.join(root, "masks"), os.path.join(root, "no_masks"))
    with pytest.raises(ValueError, match="masks"):
        readers.read_scene(root, is_exist_bg=True)
    assert readers.read_scene(root).train_cameras[0].mask is None


def test_scene_orders_cameras_and_writes_artifacts_as_jax(tmp_path):
    """The shuffled training order and the static artifacts (cameras.json,
    input.ply) are the JAX Scene's."""
    root = _colmap_set(tmp_path / "c", n=12)
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    s = Scene(ModelParams(source_path=root, model_path=mine, eval=True), seed=5)
    j = JScene(JModelParams(source_path=root, model_path=theirs, eval=True), seed=5)
    assert [c.image_name for c in s.train_cameras] == \
        [c.image_name for c in j.train_cameras]
    assert [c.image_name for c in s.train_cameras] != \
        [c.image_name for c in readers.read_scene(root, eval_split=True).train_cameras]
    assert s.cameras_extent == j.cameras_extent
    s.write_static_artifacts()
    j.write_static_artifacts()
    assert json.load(open(os.path.join(mine, "cameras.json"))) == \
        json.load(open(os.path.join(theirs, "cameras.json")))
    with open(os.path.join(mine, "input.ply"), "rb") as a, \
            open(os.path.join(theirs, "input.ply"), "rb") as b:
        assert a.read() == b.read()
    os.makedirs(os.path.join(mine, "point_cloud", "iteration_30"))
    os.makedirs(os.path.join(mine, "point_cloud", "iteration_7"))
    assert Scene.find_latest_iteration(mine) == 30


def test_pick_resolution_matches_jax():
    from gaussianmesh_tpu.data.cameras import pick_resolution as jpick
    for w, h in ((800, 800), (1920, 1080), (1601, 900), (640, 480)):
        for r in (-1, 1, 2, 4, 8, 400, 1600):
            assert cameras.pick_resolution(w, h, r) == jpick(w, h, r), (w, h, r)


def test_import_walk_covers_the_training_slice():
    """`test_torch_import.py`'s walk of the package reaches every module of
    this slice."""
    from test_torch_import import _modules
    mods = set(_modules())
    for m in ("io.colmap", "io.png", "data.readers", "scene", "utils.checkpoint",
              "utils.logging", "train.bg_trainer", "cli.train_mesh", "cli.train_bg",
              "cli.render"):
        assert f"gaussianmesh_tpu_torch.{m}" in mods, m
