"""Writes the arithmetic-coded JPEG (SOF9, SOF10) fixtures of
`tests/data/jpeg_arith/` and their digests, for the tests and
`chip_smoke.py`'s phase 9b (the card's machine has no PIL to check the
port's reader against).

    python tools/make_jpeg_arith_fixtures_torch.py [--out tests/data/jpeg_arith]

Runs only where PIL is installed. Every file is the port's own writer's
(`io/jpeg.py::encode_jpeg(..., arithmetic=True)`) or made here from its
pieces (`arith_scans`, the QM encoder `gm_jpeg_arith_encode`): gray;
YCbCr at 4:4:4, 4:2:2, 4:2:0 and 4:4:0; RGB under an Adobe marker of
transform 0; CMYK and YCCK; quality 100 (long magnitude chains); 1x1 and
odd sizes; restart intervals that are not whole MCU rows; DAC segments of
non-default L / U / Kx on conditioning tables 0-3; one scan a component;
`jpeg_simple_progression`'s script and one with refinements down from Al 2
and 3 on DC and AC. Then what the port refuses: a DC difference past 2^15
(libjpeg warns "bad arithmetic code" and PIL gives a picture; the port
raises), a stream cut before its EOI and a lossless arithmetic file
(SOF11), which PIL cannot load either.

`digests.json` holds, per file, PIL's format and mode, the rule the port
applies (none; B14: CMYK -> PIL's `convert("RGB")`) and the SHA-256 and
shape of the array it gives, or no array where the port raises:
"refused" where PIL fails too, "bad arithmetic code" with PIL's own array
beside it (`pil_array`, `pil_shape`). All files are under PIL's 65,536-byte
read block, past which PIL cannot load an arithmetic-coded JPEG (B39).
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
OUT = os.path.join(ROOT, "tests", "data", "jpeg_arith")
sys.path.insert(0, ROOT)

from tools.make_raw_sample_fixtures_torch import digests, natural, sha  # noqa: E402

# a DAC of every table: L / U per DC table and Kx per AC table
DAC_ALL = ((0, 2, 1, 3), (1, 5, 4, 3), (1, 20, 63, 5))


def pieces(img: np.ndarray, quality: int, subsampling: str, color: str, app: bytes, sof: int,
           script, tabs=None, restart: int = 0, dac=None) -> bytes:
    """`img` coded as `encode_jpeg` codes it, with the marker segment `app`,
    frame marker `sof`, `script` (None: one interleaved sequential scan)
    and conditioning tables `tabs` (default: each component's quantisation
    table's)."""
    from gaussianmesh_tpu_torch.io import jpeg

    h, w = img.shape[:2]
    qs, samp, qsel, grids = jpeg._coefficients(img, quality, subsampling, color)
    out = jpeg._headers(h, w, qs, samp, qsel, sof, app)
    if restart:
        out.append(jpeg._segment(0xDD, struct.pack(">H", restart)))
    script = script or [(tuple(range(len(samp))), 0, 63, 0, 0)]
    out += jpeg.arith_scans(h, w, samp, grids, script, tabs or qsel, restart, dac)
    return b"".join(out + [b"\xff\xd9"])


def one_a_component(nc: int) -> list:
    """Sequential scans, one a component."""
    return [((c,), 0, 63, 0, 0) for c in range(nc)]


def deep_refinement(nc: int) -> list:
    """A progression whose refinements run down from Al 2 (DC) and Al 3
    (AC), two bands each AC first scan."""
    every = tuple(range(nc))
    out = [(every, 0, 0, 0, 2)]
    for c in every:
        out += [((c,), 1, 9, 0, 3), ((c,), 10, 63, 0, 3)]
    out += [(every, 0, 0, 2, 1)]
    for c in every:
        out += [((c,), 1, 63, 3, 2), ((c,), 1, 63, 2, 1)]
    out += [(every, 0, 0, 1, 0)] + [((c,), 1, 63, 1, 0) for c in every]
    return out


def bad_code(h: int = 8, w: int = 24) -> bytes:
    """A gray sequential file whose second block's DC difference is 40,000:
    the decoder's magnitude chain passes 2^15 (libjpeg: "Corrupt JPEG data:
    bad arithmetic code", the rest of the interval zero)."""
    from gaussianmesh_tpu_torch.io import jpeg

    qs, samp, qsel, grids = jpeg._coefficients(natural(h, w, 1, 9)[..., 0], 90, "4:4:4")
    grids[0][0, 0, 0], grids[0][0, 1, 0] = -20000, 20000
    out = jpeg._headers(h, w, qs, samp, qsel, 0xC9)
    out += jpeg.arith_scans(h, w, samp, grids, [((0,), 0, 63, 0, 0)], qsel)
    return b"".join(out + [b"\xff\xd9"])


def sof11_flat(h: int, w: int, nc: int) -> bytes:
    """A lossless arithmetic-coded file (SOF11, predictor 1, point transform
    0) of a flat image of 128s: every difference is zero, each coded as one
    decision 0 at the first bin of the zero-context statistics of its
    table (T.81 H.1.4.3) -- the same decisions as a DC first scan of blocks
    of DC 0, which is how the port's QM encoder writes them here."""
    from gaussianmesh_tpu_torch.io import jpeg

    every = tuple(range(nc))
    grids = [np.zeros((h, w, 64), np.int64) for _ in every]
    data = jpeg.arith_scans(8 * h, 8 * w, [(1, 1)] * nc, grids, [(every, 0, 0, 0, 0)],
                            list(every))[-1]
    frame = struct.pack(">BHHB", 8, h, w, nc) + b"".join(bytes([c + 1, 0x11, 0]) for c in every)
    sos = bytes([nc]) + b"".join(bytes([c + 1, c << 4]) for c in every) + bytes([1, 0, 0])
    return b"".join([b"\xff\xd8", jpeg._segment(0xCB, frame), jpeg._segment(0xDA, sos), data,
                     b"\xff\xd9"])


def cut(data: bytes) -> bytes:
    """`data` cut halfway through its last scan's entropy-coded data."""
    sos = data.rindex(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    return data[:(start + len(data) - 2) // 2]


def files() -> dict[str, tuple[bytes, str | None]]:
    """{name: (bytes, None, "refused" or "bad arithmetic code")}."""
    from gaussianmesh_tpu_torch.io import jpeg

    enc = lambda img, q=90, sub="4:2:0", prog=False, **kw: jpeg.encode_jpeg(  # noqa: E731
        img, q, sub, prog, arithmetic=True, **kw)
    rgb, cmyk = natural(17, 23, 3, 1), natural(17, 23, 4, 2)
    gray = natural(19, 21, 1, 3)[..., 0]
    out = {
        "gray_seq_21x19.jpg": enc(gray),
        "gray_seq_1x1.jpg": enc(gray[:1, :1]),
        "gray_prog_1x1.jpg": enc(gray[:1, :1], prog=True),
        "gray_prog_deep_21x19.jpg": pieces(gray, 90, "4:4:4", "auto", jpeg._JFIF, 0xCA,
                                           deep_refinement(1)),
        "gray_seq_restart5_dac_21x19.jpg": enc(gray, restart=5, dac=DAC_ALL),
        "ycc444_seq_23x17.jpg": enc(rgb, sub="4:4:4"),
        "ycc422_seq_23x17.jpg": enc(rgb, sub="4:2:2"),
        "ycc420_seq_23x17.jpg": enc(rgb),
        "ycc440_seq_23x17.jpg": enc(rgb, sub="4:4:0"),
        "ycc420_prog_23x17.jpg": enc(rgb, prog=True),
        "ycc422_prog_restart2_23x17.jpg": enc(rgb, sub="4:2:2", prog=True, restart=2),
        "ycc444_prog_deep_23x17.jpg": pieces(rgb, 90, "4:4:4", "auto", jpeg._JFIF, 0xCA,
                                             deep_refinement(3)),
        "ycc420_seq_q100_23x17.jpg": enc(rgb, 100),
        "ycc420_prog_q100_23x17.jpg": enc(rgb, 100, prog=True),
        "ycc444_seq_restart5_23x17.jpg": enc(rgb, sub="4:4:4", restart=5),
        "ycc420_seq_noninterleaved_23x17.jpg": pieces(rgb, 90, "4:2:0", "auto", jpeg._JFIF,
                                                      0xC9, one_a_component(3)),
        "ycc422_seq_noninterleaved_restart4_dac_23x17.jpg": pieces(
            rgb, 90, "4:2:2", "auto", jpeg._JFIF, 0xC9, one_a_component(3), None, 4, DAC_ALL),
        "ycc440_prog_dac_23x17.jpg": enc(rgb, sub="4:4:0", prog=True, dac=DAC_ALL),
        "ycc420_seq_1x1.jpg": enc(rgb[:1, :1]),
        "ycc420_prog_odd_3x5.jpg": enc(rgb[:5, :3], prog=True),
        "rgb_adobe0_seq_23x17.jpg": pieces(rgb, 90, "4:4:4", "as_is", jpeg._adobe(0), 0xC9,
                                           None),
        "cmyk_seq_b14_23x17.jpg": enc(cmyk),
        "cmyk_prog_b14_23x17.jpg": enc(cmyk, prog=True),
        "cmyk_seq_tables0123_dac_b14_23x17.jpg": pieces(
            cmyk, 90, "4:4:4", "auto", jpeg._adobe(0), 0xC9, None, [0, 1, 2, 3], 3, DAC_ALL),
        "ycck_seq_b14_23x17.jpg": enc(cmyk, color="ycck"),
        "ycck_prog_b14_23x17.jpg": enc(cmyk, prog=True, color="ycck"),
    }
    refused = {
        "ycc420_seq_cut_refused_23x17.jpg": cut(enc(rgb)),
        "gray_sof11_refused_8x8.jpg": sof11_flat(8, 8, 1),
        "rgb_sof11_refused_5x3.jpg": sof11_flat(3, 5, 3),
    }
    return {**{k: (v, None) for k, v in out.items()},
            **{k: (v, "refused") for k, v in refused.items()},
            "gray_seq_badcode_24x8.jpg": (bad_code(), "bad arithmetic code")}


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


def bad_code_digest(data: bytes) -> dict:
    """PIL loads the file (libjpeg only warns); the port raises."""
    from PIL import Image

    im = Image.open(io.BytesIO(data))
    a = np.asarray(im)
    return {"array": None, "shape": None, "pil_format": im.format, "pil_mode": im.mode,
            "rule": "bad arithmetic code", "pil_array": sha(a), "pil_shape": list(a.shape)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    table = {}
    for name, (data, rule) in files().items():
        if len(data) > 65536:
            raise AssertionError(f"{name}: {len(data)} bytes, past PIL's read block (B39)")
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        table[name] = (digests(data) if rule is None else refused_digest(data)
                       if rule == "refused" else bad_code_digest(data))
    with open(os.path.join(args.out, "digests.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({"files": len(table), "bytes": sum(
        os.path.getsize(os.path.join(args.out, n)) for n in table)}))


if __name__ == "__main__":
    main()
