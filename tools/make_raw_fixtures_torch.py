"""Writes the PNM, TGA, QOI, SGI and PCX fixtures of `tests/data/raw/` and
their digests, for the tests and `chip_smoke.py`'s phase 9g (the card's
machine has no PIL to check the port's readers against).

    python tools/make_raw_fixtures_torch.py [--out tests/data/raw]

Runs only where PIL is installed. The `pil_*` files are PIL-written (P4,
P5 at 8 and 16 bits, P6; TGA gray, 1-bit, gray + alpha, RGB RLE, RGBA
top-down, colour-mapped RLE; QOI RGB and RGBA; SGI gray, RGB, RGBA and
16-bit RGB; PCX 1-bit, gray, palette and RGB). The `hand_*` files are the
forms PIL reads and does not write, written by the port's writers
(`io/pnm.py`, `io/tga.py`, `io/sgi.py`) or by hand here: ASCII P1 / P2 /
P3 with comments, a P5 of maxval 100, a P2 of maxval 1000; 16-bit TGAs,
a 16-bit colour map, an ID field and a first map entry of 3, a literal
packet running over rows, each corner of origin, 32- and 16-bit TGAs whose
descriptor has no alpha bits; RLE SGI at 8 and 16 bits; PCX 1 x 2 and
1 x 4. `digests.json` holds, per file, PIL's mode, the rule the port
applies to PIL's array (none; B15 palette -> its `convert("RGB")` or
`convert("RGBA")`; B16 1-bit -> `convert("L")`; B19 16-bit gray -> the
high byte; B20 no alpha bits -> the alpha dropped), and the SHA-256 and
shape of the array the rule gives.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "raw")


def natural(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Smooth gradients plus seeded noise, flat patches for runs, (h, w, c)
    uint8."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 11.0 - k)
                     for k in range(c)], -1)
    img = np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)
    img[h // 3:h // 2, w // 4:w // 2] = img[h // 3, w // 4]
    return img


def port_array(data: bytes) -> tuple[np.ndarray, str, str]:
    """PIL's array of a file with the port's rule applied -> (array, PIL's
    mode, the rule)."""
    from PIL import Image

    im = Image.open(io.BytesIO(data))
    alpha_bits = data[17] & 15 if im.format == "TGA" else None
    if im.mode == "P":
        rgba = im.palette.mode == "RGBA" and alpha_bits
        return np.asarray(im.convert("RGBA" if rgba else "RGB")), im.mode, "B15"
    if im.mode == "1":
        return np.asarray(im.convert("L")), im.mode, "B16"
    if im.mode == "I":
        return (np.asarray(im).astype(np.int64) >> 8).astype(np.uint8), im.mode, "B19"
    a = np.asarray(im)
    if alpha_bits == 0 and im.mode in ("RGBA", "LA"):
        return np.ascontiguousarray(a[..., :-1] if im.mode == "RGBA" else a[..., 0]), \
            im.mode, "B20"
    return a, im.mode, ""


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def digests(data: bytes) -> dict:
    a, mode, rule = port_array(data)
    return {"array": sha(a), "shape": list(a.shape), "pil_mode": mode, "rule": rule}


def _tga_head(w, h, kind, depth, desc, cmap=b"", first=0, map_depth=0, ident=b""):
    n = len(cmap) // (map_depth // 8) if cmap else 0
    return struct.pack("<BBBHHBHHHHBB", len(ident), int(bool(cmap)), kind, first, n,
                       map_depth, 0, 0, w, h, depth, desc) + ident + cmap


def _pcx_planes(w, h, planes, seed):
    """A hand-made 1-bit PCX of `planes` planes, its rows RLE-coded, the
    header's palette seeded."""
    rng = np.random.default_rng(seed)
    stride = (w + 7) // 8
    stride += stride % 2
    rows = rng.integers(0, 256, (h, planes * stride), dtype=np.uint8)
    rows[:, 1:3] = rows[:, :1]
    body = bytearray()
    for b in rows.ravel():
        body += bytes([0xC1, b]) if b >= 0xC0 else bytes([b])
    head = struct.pack("<BBBBHHHHHH", 10, 5, 1, 1, 0, 0, w - 1, h - 1, 72, 72)
    head += rng.integers(0, 256, 48, dtype=np.uint8).tobytes() + bytes([0, planes])
    head += struct.pack("<HH", stride, 1)
    return head.ljust(128, b"\0") + bytes(body)


def files() -> dict[str, bytes]:
    from PIL import Image

    sys.path.insert(0, ROOT)
    from gaussianmesh_tpu_torch.io import pnm, sgi, tga

    def pil(img, fmt, convert=None, **kw):
        im = Image.fromarray(img)
        buf = io.BytesIO()
        (im.convert(convert) if convert else im).save(buf, fmt, **kw)
        return buf.getvalue()

    rgb, rgba = natural(17, 23, 3, 1), natural(19, 21, 4, 2)
    gray = rgb[..., 0]
    wide = (natural(17, 23, 1, 3)[..., 0].astype(np.uint16) * 251 + 7).astype(np.uint16)
    v16 = (rgba.astype(np.uint32) * 0x0101).astype(np.uint16)
    b16 = ((rgb[..., 0].astype(np.uint16) >> 3) << 10 | (rgb[..., 1].astype(np.uint16) >> 3)
           << 5 | (rgb[..., 2].astype(np.uint16) >> 3) | (gray > 128).astype(np.uint16) << 15)
    idx = (gray % 40).astype(np.uint8)
    # a literal packet of 30 pixels over rows 0 and 1, then a run of 16
    literal_rows = bytes([29]) + bytes(range(70, 100)) + bytes([0x80 + 15, 9])
    out = {
        "pil_p4_23x17.pbm": pil(gray > 128, "PPM"),
        "pil_p5_23x17.pgm": pil(gray, "PPM"),
        "pil_p5_16bit_23x17.pgm": pil(wide, "PPM"),
        "pil_p6_23x17.ppm": pil(rgb, "PPM"),
        "pil_tga_gray_23x17.tga": pil(gray, "TGA"),
        "pil_tga_1bit_23x17.tga": pil(gray > 128, "TGA"),
        "pil_tga_la_23x17.tga": pil(rgba[..., :2], "TGA"),
        "pil_tga_rgb_rle_23x17.tga": pil(rgb, "TGA", rle=True),
        "pil_tga_rgba_top_21x19.tga": pil(rgba, "TGA", orientation=1),
        "pil_tga_palette_rle_23x17.tga": pil(rgb, "TGA", convert="P", rle=True),
        "pil_qoi_rgb_23x17.qoi": pil(rgb, "QOI"),
        "pil_qoi_rgba_21x19.qoi": pil(rgba, "QOI"),
        "pil_sgi_gray_23x17.sgi": pil(gray, "SGI"),
        "pil_sgi_rgb_23x17.sgi": pil(rgb, "SGI"),
        "pil_sgi_rgba_21x19.sgi": pil(rgba, "SGI"),
        "pil_sgi_rgb16_23x17.sgi": pil(rgb, "SGI", bpc=2),
        "pil_pcx_1bit_23x17.pcx": pil(gray > 128, "PCX"),
        "pil_pcx_gray_23x17.pcx": pil(gray, "PCX"),
        "pil_pcx_palette_23x17.pcx": pil(rgb, "PCX", convert="P"),
        "pil_pcx_rgb_23x17.pcx": pil(rgb, "PCX"),
        "hand_p1_nospace_23x17.pbm": (b"P1\n# no spaces\n23 17\n" + b"\n".join(
            b"".join(b"1" if x else b"0" for x in r) for r in gray > 100) + b"\n"),
        "hand_p2_comments_maxval1000_23x17.pgm": pnm.encode_pnm(
            (wide % 1001).astype(np.uint16), ascii=True, maxval=1000).replace(
            b"\n", b" # a comment\n", 3),
        "hand_p3_comments_23x17.ppm": pnm.encode_pnm(rgb, ascii=True).replace(
            b"255\n", b"255\n# samples\n", 1),
        "hand_p5_maxval100_23x17.pgm": pnm.encode_pnm((gray % 101).astype(np.uint8),
                                                      maxval=100),
        "hand_tga_16bit_1alpha_23x17.tga": _tga_head(23, 17, 2, 16, 0x21)
        + b16.astype("<u2").tobytes(),
        "hand_tga_16bit_noalpha_23x17.tga": _tga_head(23, 17, 2, 16, 0x20)
        + b16.astype("<u2").tobytes(),
        "hand_tga_16bit_rle_bottom_right_23x17.tga": tga.encode_tga(
            rgb, rle=True, bits16=True, right_to_left=True),
        "hand_tga_32bit_noalpha_21x19.tga": tga.encode_tga(rgba, alpha_bits=0),
        "hand_tga_32bit_rle_top_right_21x19.tga": tga.encode_tga(
            rgba, rle=True, top_down=True, right_to_left=True),
        "hand_tga_24bit_bottom_left_id_23x17.tga": _tga_head(23, 17, 2, 24, 0x00,
                                                             ident=b"view 7")
        + rgb[::-1, :, ::-1].tobytes(),
        "hand_tga_map16_first3_23x17.tga": _tga_head(
            23, 17, 1, 8, 0x21, cmap=v16[0, :40].astype("<u2").tobytes(), first=3,
            map_depth=16) + np.clip(idx, 3, 42).tobytes(),
        "hand_tga_literal_over_rows_23x2.tga": _tga_head(23, 2, 11, 8, 0x20)
        + literal_rows,
        "hand_sgi_rle_rgb_23x17.sgi": sgi.encode_sgi(rgb, rle=True),
        "hand_sgi_rle16_rgba_21x19.sgi": sgi.encode_sgi(v16, bpc=2, rle=True),
        "hand_pcx_1x2_23x17.pcx": _pcx_planes(23, 17, 2, 5),
        "hand_pcx_1x4_23x17.pcx": _pcx_planes(23, 17, 4, 6),
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
