"""Writes the SUN, MSP, XBM, XPM and PSD fixtures of `tests/data/rle_text/`
and their digests, for the tests and `chip_smoke.py`'s phase 9j (the card's
machine has no PIL to check the port's readers against).

    python tools/make_rle_text_fixtures_torch.py [--out tests/data/rle_text]

Runs only where PIL is installed. The `pil_*` files are PIL-written (PIL
writes XBM, with and without a hotspot, and MSP version 1, and no other of
these five). The `hand_*` files are written by the port's writers
(`io/sun.py`, `io/msp.py`, `io/xbm.py`, `io/xpm.py`, `io/psd.py`) or edited
by hand here: Sun rasters of every depth, raw and byte-encoded, with
colour maps, and byte-encoded ones whose rows are an odd number of bytes
(B24); MSP version 2 with blank rows and a row that runs into the next;
XBMs of one-digit, `0X` and commented literals (B29); XPMs of a palette,
of 300 colours at 2 characters a pixel, of `#RGB` and `#RRRRGGGGBBBB`
colours (B25) and of rows that run on; PSDs raw and PackBits, gray, RGB,
RGBA, CMYK (B14), indexed (B15), bitmap (B28), duotone, with extra
channels (B27) and with resource and layer sections.

`digests.json` holds, per file, PIL's mode, the rule the port applies to
PIL's array and the SHA-256 and shape of the array the rule gives. The
rules: none; B14 CMYK, B15 palette -> `convert("RGB")`; B16 1-bit ->
`convert("L")`; and, where PIL misreads the file, PIL's array of an
independent form of the same samples that PIL reads right, built here
without the port's readers: B24 the type-1 raster of a byte-encoded Sun
file; B25 the XPM with each colour rewritten as X11's `#RRGGBB`; B27 the
raw PSD of the PackBits planes (decoded by PIL's own PackBits decoder);
B28 the bitmap PSD's `convert("L")` inverted; B29 the XBM with each literal
rewritten as two hex digits.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import re
import struct
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "rle_text")


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


# ------------------------------------------------ the independent oracles

def sun_type1(data: bytes) -> bytes:
    """B24: a byte-encoded (type 2) Sun raster -> the type-1 file of its
    raster: the stream expanded (0x80 0 -> 0x80, 0x80 c v -> c + 1 v's) to
    height rows of the 16-bit-padded stride."""
    w, h, depth, _, _, _, map_len = struct.unpack_from(">7I", data, 4)
    total = (w * depth + 15) // 16 * 2 * h
    src, out, i = data[32 + map_len:], bytearray(), 0
    while len(out) < total:
        if src[i] != 0x80:
            out.append(src[i])
            i += 1
        elif src[i + 1] == 0:
            out.append(0x80)
            i += 2
        else:
            out += bytes([src[i + 2]]) * (src[i + 1] + 1)
            i += 3
    head = bytearray(data[:32 + map_len])
    head[20:24] = struct.pack(">I", 1)
    return bytes(head) + bytes(out[:total])


def xpm_six_digits(data: bytes) -> bytes:
    """B25: an XPM with each `c #...` colour of 3, 9 or 12 digits rewritten
    as `#RRGGBB` by X11's rule (the top 8 bits of each third)."""
    def six(m):
        d = m.group(1)
        n = len(d) // 3
        parts = [int(d[k * n:(k + 1) * n], 16) for k in range(3)]
        parts = [v << 4 if n == 1 else v >> (4 * n - 8) for v in parts]
        return b"c #" + b"".join(b"%02X" % v for v in parts)
    return re.sub(rb"c #([0-9A-Fa-f]+)", six, data)


def xbm_two_digits(data: bytes) -> bytes:
    """B29: an XBM with its array's comments dropped and each literal
    written `0x` and two lowercase digits (the array after the last
    `_bits[]` in the first 512 bytes, as PIL's header regex finds it)."""
    start = [m for m in re.finditer(rb"_bits\[\]", data[:512])][-1].start()
    m = re.compile(rb"_bits\[\][^{]*\{").match(data, start)
    end = data.index(b"}", m.end())
    body = re.sub(rb"/\*.*?\*/", b" ", data[m.end():end], flags=re.S)
    vals = [int(t, 16) for t in re.findall(rb"0[xX]([0-9a-fA-F]{1,2})", body)]
    return (data[:m.start()] + b"_bits[] = {\n" + b", ".join(b"0x%02x" % v for v in vals)
            + b"};\n")


def psd_raw(data: bytes) -> bytes:
    """B27: a PackBits PSD (no resources or layers) -> the raw PSD of the
    same planes, each row decoded by PIL's own PackBits decoder."""
    from PIL import Image

    channels, h, w = struct.unpack_from(">HII", data, 12)
    at = 26 + 4 + struct.unpack_from(">I", data, 26)[0] + 8
    assert struct.unpack_from(">H", data, at)[0] == 1
    counts = struct.unpack_from(f">{channels * h}H", data, at + 2)
    pos = at + 2 + 2 * channels * h
    rows = []
    for n in counts:
        rows.append(Image.frombytes("L", (w, 1), data[pos:pos + n], "packbits", "L").tobytes())
        pos += n
    return data[:at] + struct.pack(">H", 0) + b"".join(rows)


def port_array(data: bytes) -> tuple[np.ndarray, str, str]:
    """PIL's array of a file with the port's rule applied -> (array, PIL's
    mode, the rule)."""
    from PIL import Image

    im = Image.open(io.BytesIO(data))         # loaded once no oracle replaces it
    fmt, mode = im.format, im.mode
    if fmt == "SUN" and struct.unpack_from(">I", data, 20)[0] == 2:
        w, depth = struct.unpack_from(">I", data, 4)[0], struct.unpack_from(">I", data, 12)[0]
        if (w * depth + 7) // 8 % 2:
            return port_array(sun_type1(data))[0], mode, "B24"
    if fmt == "XPM" and any(len(d) != 6 for d in re.findall(rb"c #([0-9A-Fa-f]+)", data)):
        return port_array(xpm_six_digits(data))[0], mode, "B25"
    if fmt == "XBM" and xbm_two_digits(data) != data:
        fixed = port_array(xbm_two_digits(data))[0]
        try:
            misread = not np.array_equal(fixed, np.asarray(im.convert("L")))
        except OSError:                          # PIL runs out of bytes: truncated
            misread = True
        if misread:
            return fixed, mode, "B29"
    if fmt == "PSD":
        channels, bits, psd_mode = (struct.unpack_from(">H", data, 12)[0],
                                    struct.unpack_from(">H", data, 22)[0],
                                    struct.unpack_from(">H", data, 24)[0])
        at = 26 + 4 + struct.unpack_from(">I", data, 26)[0] + 8    # no resources or layers
        if channels > len(im.getbands()) and struct.unpack_from(">H", data, at)[0] == 1:
            return port_array(psd_raw(data))[0], mode, "B27"
        if psd_mode == 0 and bits == 1:
            return 255 - np.asarray(im.convert("L")), mode, "B28"
        if mode == "CMYK":
            return np.asarray(im.convert("RGB")), mode, "B14"
    im.load()
    if mode == "P":
        return np.asarray(im.convert("RGB")), mode, "B15"
    if mode == "1":
        return np.asarray(im.convert("L")), mode, "B16"
    return np.asarray(im), mode, ""


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def digests(data: bytes) -> dict:
    a, mode, rule = port_array(data)
    return {"array": sha(a), "shape": list(a.shape), "pil_mode": mode, "rule": rule}


def files() -> dict[str, bytes]:
    from PIL import Image

    sys.path.insert(0, ROOT)
    from gaussianmesh_tpu_torch.io import msp, psd, sun, xbm, xpm

    def pil(img, fmt, **kw):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, fmt, **kw)
        return buf.getvalue()

    rgb, rgba = natural(17, 23, 3, 1), natural(19, 21, 4, 2)
    gray = rgb[..., 0]
    bits = np.random.default_rng(3).random((17, 23)) < 0.6
    even, even_rgb = banded(17, 22, 3, 4)[..., 0], banded(17, 22, 3, 5)
    odd, odd_rgb = banded(17, 23, 3, 6)[..., 0], banded(17, 23, 3, 7)
    rng = np.random.default_rng(8)
    pal = rng.integers(0, 256, (40, 3), dtype=np.uint8)
    pal256 = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    pal300 = rng.integers(0, 256, (300, 3), dtype=np.uint8)
    idx = (even % 40).astype(np.uint8)
    white_rows = bits.copy()
    white_rows[3:6] = True
    # an MSP v2 whose row 2 gives one byte more (a literal of 4 bytes for 3)
    # and row 3 one fewer: PIL joins the rows' bytes, so the rows run on
    run_on = bytearray(msp.encode_msp(white_rows, version=2, blank_rows=False))
    lengths = list(struct.unpack_from("<17H", run_on, 32))
    pos = 32 + 34 + sum(lengths[:2])
    row2 = bytes([4]) + bytes(run_on[pos + 1:pos + 4]) + b"\x5a"
    row3 = bytes([2, 0xF0, 0x0F])
    body = bytes(run_on[:pos]) + row2 + row3 + bytes(run_on[pos + sum(lengths[2:4]):])
    lengths[2], lengths[3] = len(row2), len(row3)
    run_on = body[:32] + struct.pack("<17H", *lengths) + body[32 + 34:]
    # XBM literals PIL misreads (B29): one digit, 0X, an x in a comment
    x11 = xbm.encode_xbm(bits, name="b")
    one_digit = re.sub(rb"0x0([0-9a-f])\b", rb"0x\1", x11)
    upper = x11.replace(b"{\n", b"{ /* x: a comment */\n", 1)
    upper = upper.replace(b"0x", b"0X", 5)
    xpm_pal = (gray % 40).astype(np.uint8)
    # an XPM whose pixel lines hold 25 and 21 keys in turn: they run on
    xpm_rows = xpm.encode_xpm(xpm_pal, pal, cpp=1)
    lines = xpm_rows.split(b"\n")
    first = lines.index(b"/* pixels */") + 1
    for k in range(first, first + 16, 2):
        a, b = lines[k], lines[k + 1]
        lines[k], lines[k + 1] = a[:-2] + b[1:3] + b'",', b'"' + b[3:]
    xpm_rows = b"\n".join(lines)
    sections = bytearray(psd.encode_psd(rgb, packbits=True))
    at = 26 + 4
    resources = (b"8BIM" + struct.pack(">HB", 1005, 3) + b"abc" + struct.pack(">I", 5)
                 + b"12345" + b"\0" + b"8BIM" + struct.pack(">HB", 1039, 0) + b"\0"
                 + struct.pack(">I", 4) + b"icc!")
    layers = struct.pack(">I", 2) + b"\0\0" + bytes(6)
    with_sections = (bytes(sections[:at]) + struct.pack(">I", len(resources)) + resources
                     + struct.pack(">I", len(layers)) + layers + bytes(sections[at + 8:]))
    out = {
        "pil_msp_v1_23x17.msp": pil(bits, "MSP"),
        "pil_xbm_23x17.xbm": pil(bits, "XBM"),
        "pil_xbm_hotspot_23x17.xbm": pil(bits, "XBM", hotspot=(4, 9)),
        "hand_sun_raw8_23x17.ras": sun.encode_sun(gray),
        "hand_sun_raw24_bgr_23x17.ras": sun.encode_sun(rgb),
        "hand_sun_raw32_rgbx_type3_23x17.ras": sun.encode_sun(rgb, depth=32, rgb_order=True),
        "hand_sun_raw1_23x17.ras": sun.encode_sun(bits * np.uint8(255), depth=1),
        "hand_sun_raw4_23x17.ras": sun.encode_sun(gray >> 4, depth=4),
        "hand_sun_raw8_colormap_23x17.ras": sun.encode_sun(xpm_pal, colormap=pal),
        "hand_sun_rle8_22x17.ras": sun.encode_sun(even, rle=True),
        "hand_sun_rle24_22x17.ras": sun.encode_sun(even_rgb, rle=True),
        "hand_sun_rle32_23x17.ras": sun.encode_sun(odd_rgb, depth=32, rle=True),
        "hand_sun_rle8_colormap_22x17.ras": sun.encode_sun(idx, colormap=pal, rle=True),
        "hand_sun_rle4_colormap_20x17.ras": sun.encode_sun(even[:, :20] % 16, depth=4,
                                                           colormap=pal[:16], rle=True),
        "hand_sun_rle8_b24_23x17.ras": sun.encode_sun(odd, rle=True),
        "hand_sun_rle24_b24_23x17.ras": sun.encode_sun(odd_rgb, rle=True),
        "hand_sun_rle1_b24_23x17.ras": sun.encode_sun(bits * np.uint8(255), depth=1, rle=True),
        "hand_msp_v2_blank_rows_23x17.msp": msp.encode_msp(white_rows, version=2),
        "hand_msp_v2_rows_run_on_23x17.msp": run_on,
        "hand_xbm_x11_23x17.xbm": x11,
        "hand_xbm_one_digit_b29_23x17.xbm": one_digit,
        "hand_xbm_upper_x_comment_b29_23x17.xbm": upper,
        "hand_xpm_palette_23x17.xpm": xpm.encode_xpm(xpm_pal, pal),
        "hand_xpm_256_2cpp_23x17.xpm": xpm.encode_xpm((natural(17, 23, 1, 9)[..., 0]),
                                                      pal256, cpp=2),
        "hand_xpm_rgb_300_2cpp_23x17.xpm": xpm.encode_xpm(
            rng.integers(0, 300, (17, 23)), pal300, cpp=2),
        "hand_xpm_hex3_b25_23x17.xpm": xpm.encode_xpm(xpm_pal, pal, digits=3),
        "hand_xpm_hex12_b25_23x17.xpm": xpm.encode_xpm(xpm_pal, pal, digits=12),
        "hand_xpm_rows_run_on_23x17.xpm": xpm_rows,
        "hand_psd_raw_gray_23x17.psd": psd.encode_psd(gray),
        "hand_psd_raw_rgb_23x17.psd": psd.encode_psd(rgb),
        "hand_psd_packbits_rgb_22x17.psd": psd.encode_psd(even_rgb, packbits=True),
        "hand_psd_packbits_rgba_21x19.psd": psd.encode_psd(rgba, packbits=True),
        "hand_psd_packbits_cmyk_b14_23x17.psd": psd.encode_psd(
            np.concatenate([rgb, gray[..., None] // 2], 2), mode=4, packbits=True),
        "hand_psd_raw_indexed_b15_23x17.psd": psd.encode_psd(xpm_pal, mode=2, palette=np.pad(
            pal, ((0, 216), (0, 0)))),
        "hand_psd_raw_bitmap_b28_23x17.psd": psd.encode_psd(bits * np.uint8(255), mode=0),
        "hand_psd_packbits_bitmap_b28_23x17.psd": psd.encode_psd(bits * np.uint8(255), mode=0,
                                                                packbits=True),
        "hand_psd_packbits_duotone_23x17.psd": psd.encode_psd(gray, mode=8, packbits=True),
        "hand_psd_packbits_gray_alpha_b27_23x17.psd": psd.encode_psd(gray, packbits=True,
                                                                    extra=1),
        "hand_psd_packbits_rgb_spot_b27_22x17.psd": psd.encode_psd(even_rgb, packbits=True,
                                                                  extra=2),
        "hand_psd_sections_packbits_rgb_23x17.psd": with_sections,
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
