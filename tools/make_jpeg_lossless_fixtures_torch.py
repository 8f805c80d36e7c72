"""Writes the lossless JPEG (SOF3) fixtures of `tests/data/jpeg_lossless/`
and their digests, for the tests and `chip_smoke.py`'s phase 9b (the
card's machine has no PIL to check the port's reader against).

    python tools/make_jpeg_lossless_fixtures_torch.py [--out tests/data/jpeg_lossless]

Runs only where PIL is installed. Every file is the port's own writer's
(`io/jpeg.py::encode_jpeg_lossless`) or made here from its pieces: RGB at
predictors 1-7, point transforms 0 and 2, restart intervals, gray, RGB with
no marker and with an Adobe marker of transform 0, CMYK (Adobe 0), one scan
a component, components sampled at half the largest, scans of their own
predictor and point transform, differences of category 16 and past 8 bits
(the samples wrap mod 2^16 and keep their low 8 bits); then what PIL cannot
load: three components under JFIF and under Adobe transform 1, four under
Adobe transform 2 (libjpeg-turbo converts no colour in lossless mode), a
restart interval that is not whole MCU rows, and a stream cut short.

`digests.json` holds, per file, PIL's format and mode, the rule the port
applies (none; B14: CMYK -> PIL's `convert("RGB")`) and the SHA-256 and
shape of the array it gives, or "refused" with no array where PIL fails
(the port raises naming the cause).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import struct
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "jpeg_lossless")
sys.path.insert(0, ROOT)

from tools.make_raw_sample_fixtures_torch import digests, natural  # noqa: E402


def frame(h: int, w: int, samp, marker: bytes = b"", restart: int = 0) -> list:
    """SOI, a marker segment, a lossless frame of len(samp) components of
    these (h, v) sampling factors, and a DRI where `restart` is given."""
    from gaussianmesh_tpu_torch.io import jpeg

    out = [b"\xff\xd8", marker, jpeg._segment(0xC3, struct.pack(">BHHB", 8, h, w, len(samp))
                                              + b"".join(bytes([i + 1, sh << 4 | sv, 0])
                                                         for i, (sh, sv) in enumerate(samp)))]
    if restart:
        out.append(jpeg._segment(0xDD, struct.pack(">H", restart)))
    return out


def per_scan(img: np.ndarray, predictors, pts) -> bytes:
    """One scan a component of `img`, each with its own predictor and point
    transform."""
    from gaussianmesh_tpu_torch.io import jpeg

    h, w, n = img.shape
    out = frame(h, w, [(1, 1)] * n)
    for c in range(n):
        planes = [img[..., k] >> pts[c] for k in range(n)]
        out += jpeg._lossless_scan(planes, [(1, 1)] * n, [c], predictors[c], pts[c], 0,
                                   list(range(n)))
    return b"".join(out + [b"\xff\xd9"])


def wrapping(h: int, w: int, pt: int, seed: int) -> bytes:
    """A gray image coded from random differences (predictor 1), category
    16 among them: samples past 8 bits, wrapping mod 2^16."""
    from gaussianmesh_tpu_torch.io import jpeg

    rng = np.random.default_rng(seed)
    diffs = rng.integers(-40000, 40000, (h * w, 1)).clip(-32768, 32768)
    diffs[::7] = 32768
    diffs[3::11] = -32768
    out = frame(h, w, [(1, 1)]) + jpeg.lossless_entropy(diffs, [0], [0], 1, pt)
    return b"".join(out + [b"\xff\xd9"])


def files() -> dict[str, tuple[bytes, str | None]]:
    """{name: (bytes, None, or "refused")}."""
    from gaussianmesh_tpu_torch.io import jpeg

    enc = jpeg.encode_jpeg_lossless
    rgb, cmyk = natural(17, 23, 3, 11), natural(17, 23, 4, 12)
    gray = natural(19, 21, 1, 13)[..., 0]
    out = {}
    for p in range(1, 8):
        out[f"rgb_p{p}_23x17.jpg"] = enc(rgb, p)
    out["rgb_p4_pt2_23x17.jpg"] = enc(rgb, 4, 2)
    out["gray_p7_pt2_21x19.jpg"] = enc(gray, 7, 2)
    out["gray_p1_21x19.jpg"] = enc(gray, 1)
    out["gray_p5_1x1.jpg"] = enc(gray[:1, :1], 5)
    out["rgb_p6_restart2rows_23x17.jpg"] = enc(rgb, 6, 0, 46)
    out["gray_p2_restart1row_21x19.jpg"] = enc(gray, 2, 0, 21)
    out["rgb_p1_adobe0_23x17.jpg"] = enc(rgb, 1, marker="adobe0")
    out["rgb_p3_noninterleaved_23x17.jpg"] = enc(rgb, 3, interleave=False)
    out["cmyk_p1_adobe0_b14_23x17.jpg"] = enc(cmyk, 1, marker="adobe0")
    out["cmyk_p5_noninterleaved_b14_23x17.jpg"] = enc(cmyk, 5, 1, 23, interleave=False)
    out["rgb_p7_h2v2_23x17.jpg"] = enc(rgb, 7, sampling=[(2, 2), (1, 1), (1, 1)])
    out["rgb_p2_h2v1_noninterleaved_23x17.jpg"] = enc(rgb, 2, interleave=False,
                                                      sampling=[(2, 1), (1, 1), (1, 1)])
    out["rgb_scans_p1p4p7_pt0pt1pt2_23x17.jpg"] = per_scan(rgb, (1, 4, 7), (0, 1, 2))
    out["gray_p1_category16_wrap_13x7.jpg"] = wrapping(7, 13, 0, 14)
    out["gray_p1_category16_wrap_pt3_13x7.jpg"] = wrapping(7, 13, 3, 15)
    refused = {
        "rgb_p1_jfif_refused_23x17.jpg": enc(rgb, 1, marker="jfif"),
        "rgb_p1_adobe1_refused_23x17.jpg": enc(rgb, 1, marker="adobe1"),
        "cmyk_p1_adobe2_refused_23x17.jpg": enc(cmyk, 1, marker="adobe2"),
        "rgb_p1_cut_refused_23x17.jpg": enc(rgb, 1)[:-200],
    }
    # a restart interval of 5 MCUs in 23-MCU rows: the entropy-coded data is
    # made with markers every 5 MCUs (libjpeg-turbo refuses the frame first)
    head = frame(17, 23, [(1, 1)] * 3, restart=5)
    diffs = np.zeros((23 * 17, 3), np.int64)
    diffs[0] = 1
    refused["rgb_restart5_refused_23x17.jpg"] = b"".join(
        head + jpeg.lossless_entropy(diffs, [0, 1, 2], [0, 1, 2], 1, 0, restart=5)
        + [b"\xff\xd9"])
    return {**{k: (v, None) for k, v in out.items()},
            **{k: (v, "refused") for k, v in refused.items()}}


def refused_digest(data: bytes) -> dict:
    """PIL opens the file (format and mode) and fails to load it."""
    from PIL import Image

    im = Image.open(io.BytesIO(data))
    try:
        im.load()
    except OSError:
        return {"array": None, "shape": None, "pil_format": im.format, "pil_mode": im.mode,
                "rule": "refused"}
    raise AssertionError("PIL loads a file recorded as refused")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    table = {}
    for name, (data, rule) in files().items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        table[name] = refused_digest(data) if rule else digests(data)
    with open(os.path.join(args.out, "digests.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({"files": len(table), "bytes": sum(
        os.path.getsize(os.path.join(args.out, n)) for n in table)}))


if __name__ == "__main__":
    main()
