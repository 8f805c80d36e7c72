"""Writes the TIFF and CMYK JPEG fixtures of `tests/data/tiff/` and their
digests, for the tests and `chip_smoke.py`'s phase 9f (the card's machine
has no PIL, and so no libtiff or libjpeg to check the port's readers
against).

    python tools/make_tiff_fixtures_torch.py [--out tests/data/tiff]

Runs only where PIL is installed. The files are PIL-written (JPEG-in-TIFF
of Photometric 2 and 6, each with a `JPEGTables` tag, gray JPEG-in-TIFF,
LZMA with and without predictor 2, an LZW CMYK TIFF, a CMYK JPEG with its
Adobe marker) or written by `io/tiff.py::write_tiff` and
`io/jpeg.py::write_jpeg` (YCbCr 4:2:0 JPEG-in-TIFF in strips of 16 rows
and in tiles, tiled 16-bit Deflate with predictor 2 and 1-pixel edge
tiles, a planar LZW file with predictor 2, a tiled planar CMYK file, a
YCCK JPEG at 4:2:0). `digests.json` holds, per file, the SHA-256 of PIL's
`np.asarray(Image.open(...))` (of its `convert("RGB")` for a CMYK image)
and that array's shape and PIL's mode.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "tiff")


def natural(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Smooth gradients plus seeded noise, (h, w, c) uint8."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 11.0 - k)
                     for k in range(c)], -1)
    return np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)


def pil_array(data: bytes) -> np.ndarray:
    """PIL's array of a file: `np.asarray(Image.open(...))`, or its
    `convert("RGB")` where PIL opens it as CMYK."""
    from PIL import Image

    im = Image.open(io.BytesIO(data))
    return np.asarray(im.convert("RGB") if im.mode == "CMYK" else im)


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def digests(data: bytes) -> dict:
    from PIL import Image

    a = pil_array(data)
    return {"array": sha(a), "shape": list(a.shape),
            "pil_mode": Image.open(io.BytesIO(data)).mode}


def files() -> dict[str, bytes]:
    from PIL import Image

    sys.path.insert(0, ROOT)
    from gaussianmesh_tpu_torch.io import jpeg, tiff

    def pil(img, fmt="TIFF", mode=None, convert=None, **kw):
        im = Image.fromarray(img, mode) if mode else Image.fromarray(img)
        buf = io.BytesIO()
        (im.convert(convert) if convert else im).save(buf, fmt, **kw)
        return buf.getvalue()

    rgb, rgba = natural(37, 53, 3, 1), natural(17, 33, 4, 2)
    wide = natural(40, 70, 3, 3)
    return {
        "pil_jpeg_rgb_53x37.tif": pil(rgb, compression="jpeg", quality=85),
        "pil_jpeg_ycbcr_53x37.tif": pil(rgb, convert="YCbCr", compression="jpeg"),
        "pil_jpeg_gray_53x37.tif": pil(rgb[..., 0], compression="jpeg", quality=60),
        "pil_lzma_rgb_53x37.tif": pil(rgb, compression="lzma"),
        "pil_lzma_p2_rgba_33x17.tif": pil(rgba, mode="RGBA", compression="lzma",
                                          tiffinfo={317: 2}),
        "pil_cmyk_lzw_53x37.tif": pil(rgb, convert="CMYK", compression="tiff_lzw"),
        "pil_cmyk_q90_53x37.jpg": pil(rgb, "JPEG", convert="CMYK", quality=90),
        "writer_jpeg_ycbcr420_strips16_70x40.tif": tiff.encode_tiff(
            wide, "jpeg", ycbcr=True, rows_per_strip=16, quality=80),
        "writer_jpeg_ycbcr420_tiles32_70x40.tif": tiff.encode_tiff(
            wide, "jpeg", ycbcr=True, tile=(32, 32), quality=80, byteorder=">"),
        "writer_tiled16_deflate_p2_33x17.tif": tiff.encode_tiff(
            rgba.astype(np.uint16) * 257, "deflate", predictor=2, tile=(16, 16)),
        "writer_planar_lzw_p2_70x40.tif": tiff.encode_tiff(
            wide, "lzw", predictor=2, planar=True, rows_per_strip=7),
        "writer_cmyk_tiled_planar_packbits_33x17.tif": tiff.encode_tiff(
            rgba, "packbits", cmyk=True, planar=True, tile=(16, 16), byteorder=">"),
        "writer_ycck420_q90_53x37.jpg": jpeg.encode_jpeg(natural(37, 53, 4, 4), 90,
                                                         color="ycck"),
    }


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
