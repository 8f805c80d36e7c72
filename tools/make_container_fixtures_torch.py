"""Writes the DIB, ICO, CUR, DCX and ICNS fixtures of `tests/data/containers/`
and their digests, for the tests and `chip_smoke.py`'s phase 9i (the card's
machine has no PIL to check the port's readers against).

    python tools/make_container_fixtures_torch.py [--out tests/data/containers]

Runs only where PIL is installed. The `pil_*` files are PIL-written: DIBs
of modes RGB, RGBA (which PIL reads back as RGB), P, L and 1; ICOs of PNG
frames (RGB, RGBA, P, three sizes in one file) and of BMP frames (24 bits
with an AND mask, 32 bits, 8-bit palette, 1 bit); an ICNS. The `hand_*`
files are the forms PIL reads and does not write, written by the port's
writers (`io/bmp.py`, `io/ico.py`, `io/pcx.py`, `io/icns.py`) or by hand
here: a BI_BITFIELDS RGBA DIB; CURs (the pick of the largest, a width
byte of 0 read as 0, a 32-bit frame at byte 22, an 8-bit frame); DCXs of
two pages (RGB first, gray first); ICOs of an 8-bit frame with a mask, a
PNG frame whose directory says 0 x 0, ties of size broken by depth and by
order, an entry with no bit count, B23's 32-bit frame of zero fourth
bytes; ICNS `it32` / `ih32` / `il32` / `is32` images, run-length coded or
raw, with and without their masks, and a PNG sub-image beside an `it32`.
`digests.json` holds, per file, PIL's mode, the rule the port applies to
PIL's array (none; B15 palette -> its `convert("RGB")`; B16 1-bit -> its
`convert("L")`; B23 -> PIL's RGB and the AND mask's alpha), and the
SHA-256 and shape of the array the rule gives.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct
import sys
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "containers")


def natural(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Smooth gradients plus seeded noise, flat patches, (h, w, c) uint8."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 11.0 - k)
                     for k in range(c)], -1)
    img = np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)
    img[h // 3:h // 2, w // 4:w // 2] = img[h // 3, w // 4]
    return img


def banded(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Smooth gradients in steps of 24 with a seeded 5 % speckle: runs and
    literals for run-length codes, small files."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 23.0 + k) * np.cos(y / 31.0 - k)
                    for k in range(c)], -1).astype(np.uint8) // 24 * 24
    spots = rng.random((h, w)) < 0.05
    img[spots] = rng.integers(0, 256, (int(spots.sum()), c), dtype=np.uint8)
    return img


def and_mask_alpha(data: bytes, im) -> np.ndarray | None:
    """B23: the alpha of the AND mask of an ICO's 32-bit frame whose fourth
    bytes are all 0, read by PIL's own rule for masks (None where the entry
    holds no mask after the pixel rows: alpha 255)."""
    from PIL import Image

    e = im.ico.entry[0]
    w, h = im.size
    stride = -(-w // 32) * 4
    at = e.offset + e.size - stride * h
    hsize = struct.unpack_from("<I", data, e.offset)[0]
    if at < e.offset + hsize + w * h * 4 or at + stride * h > len(data):
        return None
    mask = Image.frombuffer("1", (w, h), data[at:at + stride * h], "raw", ("1;I", stride, -1))
    return np.asarray(mask.convert("L"))


def port_array(data: bytes) -> tuple[np.ndarray, str, str]:
    """PIL's array of a file with the port's rule applied -> (array, PIL's
    mode, the rule)."""
    from PIL import Image

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # ICO: "Image was not the expected size"
        im = Image.open(io.BytesIO(data))
        im.load()
    if im.mode == "P":
        rgba = im.palette.mode == "RGBA" or "transparency" in im.info
        return np.asarray(im.convert("RGBA" if rgba else "RGB")), im.mode, "B15"
    if im.mode == "1":
        return np.asarray(im.convert("L")), im.mode, "B16"
    a = np.asarray(im)
    if (im.format == "ICO" and im.mode == "RGBA" and im.ico.entry[0].bpp == 32
            and not a[..., 3].any()):
        alpha = and_mask_alpha(data, im)
        a = a.copy()
        a[..., 3] = 255 if alpha is None else alpha
        return a, im.mode, "B23"
    return a, im.mode, ""


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def digests(data: bytes) -> dict:
    a, mode, rule = port_array(data)
    return {"array": sha(a), "shape": list(a.shape), "pil_mode": mode, "rule": rule}


def files() -> dict[str, bytes]:
    from PIL import Image

    sys.path.insert(0, ROOT)
    from gaussianmesh_tpu_torch.io import bmp, icns, ico, pcx

    def pil(img, fmt, convert=None, **kw):
        im = Image.fromarray(img)
        buf = io.BytesIO()
        (im.convert(convert) if convert else im).save(buf, fmt, **kw)
        return buf.getvalue()

    rgb, rgba = natural(17, 23, 3, 1), natural(19, 21, 4, 2)
    gray = rgb[..., 0]
    mask = natural(17, 23, 1, 3)[..., 0] > 140
    rng = np.random.default_rng(4)
    pal = rng.integers(0, 256, (40, 3), dtype=np.uint8)
    idx = (gray % 40).astype(np.uint8)
    zero = np.concatenate([rgb, np.zeros((17, 23, 1), np.uint8)], 2)
    flat = np.zeros((32, 32, 4), np.uint8)    # flat quadrants: a small PIL ICNS
    flat[:16, :16], flat[:16, 16:], flat[16:, :16], flat[16:, 16:] = (
        (200, 30, 30, 255), (30, 200, 30, 255), (30, 30, 200, 128), (250, 250, 250, 0))
    big = banded(257, 260, 3, 13)
    it32, t8mk = banded(128, 128, 3, 5), banded(128, 128, 1, 6)[..., 0]
    il32, l8mk = banded(32, 32, 3, 7), natural(32, 32, 1, 8)[..., 0]
    # a CUR whose second entry's width byte is 0: PIL's pick reads it as 0
    cur_zero = bytearray(ico.encode_cur([dict(img=rgb[:9, :11], mask=mask[:9, :11]),
                                         dict(img=rgba[:17, :, :3], mask=mask[:, :21])]))
    cur_zero[6 + 16] = 0
    # an ICO entry with no bit count and 16 colours: depth ceil(log2(16)) = 4, below 24
    no_bpp_ico = bytearray(ico.encode_ico([dict(img=rgb, mask=mask),
                                           dict(img=idx, palette=pal, mask=~mask, bpp=0)]))
    no_bpp_ico[6 + 16 + 2] = 16
    out = {
        "pil_dib_rgb_23x17.dib": pil(rgb, "DIB"),
        "pil_dib_rgba_21x19.dib": pil(rgba, "DIB"),
        "pil_dib_p_23x17.dib": pil(rgb, "DIB", convert="P"),
        "pil_dib_l_23x17.dib": pil(gray, "DIB"),
        "pil_dib_1_23x17.dib": pil(gray > 128, "DIB"),
        "pil_ico_png_rgb_23x17.ico": pil(rgb, "ICO", sizes=[(23, 17)]),
        "pil_ico_png_rgba_21x19.ico": pil(rgba, "ICO", sizes=[(21, 19)]),
        "pil_ico_png_p_23x17.ico": pil(rgb, "ICO", convert="P", sizes=[(23, 17)]),
        "pil_ico_png_three_sizes_64x64.ico": pil(natural(64, 64, 4, 9), "ICO",
                                                 sizes=[(16, 16), (32, 32), (64, 64)]),
        "pil_ico_bmp_rgb_23x17.ico": pil(rgb, "ICO", bitmap_format="bmp", sizes=[(23, 17)]),
        "pil_ico_bmp_rgba_21x19.ico": pil(rgba, "ICO", bitmap_format="bmp",
                                          sizes=[(21, 19)]),
        "pil_ico_bmp_p_23x17.ico": pil(rgb, "ICO", convert="P", bitmap_format="bmp",
                                       sizes=[(23, 17)]),
        "pil_ico_bmp_1_23x17.ico": pil(gray > 128, "ICO", bitmap_format="bmp",
                                       sizes=[(23, 17)]),
        "pil_icns_flat_32x32.icns": pil(flat, "ICNS"),
        "hand_dib_bitfields_rgba_21x19.dib": bmp.encode_dib(rgba, bitfields=True),
        "hand_cur_pick_largest_23x17.cur": ico.encode_cur(
            [dict(img=rgb[:9, :11], mask=mask[:9, :11]), dict(img=rgb, mask=mask),
             dict(img=rgb[:17, :20], mask=mask[:, :20])]),
        "hand_cur_zero_width_byte.cur": bytes(cur_zero),
        "hand_cur_32bit_at22_21x19.cur": ico.encode_cur([dict(img=rgba)]),
        "hand_cur_8bit_23x17.cur": ico.encode_cur([dict(img=idx, palette=pal, mask=mask)]),
        "hand_dcx_rgb_then_gray_23x17.dcx": pcx.encode_dcx([rgb, gray[:5, :7]]),
        "hand_dcx_gray_then_rgb_23x17.dcx": pcx.encode_dcx([gray, rgb[:6, :4]]),
        "hand_ico_bmp8_mask_23x17.ico": ico.encode_ico([dict(img=idx, palette=pal,
                                                             mask=mask)]),
        "hand_ico_png_0x0_260x257.ico": ico.encode_ico([dict(img=big, form="png",
                                                             size=(0, 0))]),
        "hand_ico_tie_depth_23x17.ico": ico.encode_ico(
            [dict(img=np.concatenate([rgb, mask[..., None] * np.uint8(255)], 2)),
             dict(img=rgb, mask=mask), dict(img=rgb[:5, :5], mask=mask[:5, :5])]),
        "hand_ico_tie_order_23x17.ico": ico.encode_ico(
            [dict(img=rgb, mask=mask), dict(img=rgb[::-1], mask=~mask)]),
        "hand_ico_no_bpp_23x17.ico": bytes(no_bpp_ico),
        "hand_ico_b23_23x17.ico": ico.encode_ico([dict(img=zero, mask=mask)]),
        "hand_icns_it32_t8mk_128x128.icns": icns.encode_icns({b"it32": it32,
                                                             b"t8mk": t8mk}),
        "hand_icns_il32_l8mk_32x32.icns": icns.encode_icns({b"il32": il32, b"l8mk": l8mk}),
        "hand_icns_il32_nomask_32x32.icns": icns.encode_icns({b"il32": il32}),
        "hand_icns_ih32_raw_48x48.icns": icns.encode_icns(
            {b"is32": natural(16, 16, 3, 10), b"ih32": natural(48, 48, 3, 11)}, rle=False),
        "hand_icns_png_beside_it32_128x128.icns": icns.encode_icns(
            {b"it32": it32, b"ic07": banded(128, 128, 4, 12), b"t8mk": t8mk}),
    }
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    table = {}
    for name, data in files().items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        table[name] = digests(data)
    with open(os.path.join(args.out, "digests.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({"files": len(table), "bytes": sum(
        os.path.getsize(os.path.join(args.out, n)) for n in table)}))


if __name__ == "__main__":
    main()
