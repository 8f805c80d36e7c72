"""Writes the FLI, GBR, IM, IMT, IPTC, PIXAR, MCIDAS, XV thumbnail, FITS,
SPIDER and FTEX fixtures of `tests/data/raw_samples/` and their digests,
for the tests and `chip_smoke.py`'s phases 9k and 9l (the card's machine
has no PIL to check the port's readers against).

    python tools/make_raw_sample_fixtures_torch.py [--out tests/data/raw_samples]

Runs only where PIL is installed. The `pil_*` files are PIL-written (PIL
writes IM, in modes 1, L, LA, P, PA, RGB, RGBA, RGBX, CMYK, YCbCr and
I;16 / I;16L / I;16B among others, and none of the other four formats). The
`hand_*` files are written by the port's writers (`io/fli.py`, `io/gbr.py`,
`io/im.py`, `io/imt.py`, `io/iptc.py`) or edited by hand here: FLI and FLC
frames of each chunk kind (BRUN, COPY, LC, SS2, BLACK, the stamp), 256-
and 64-level palettes and palette packets with skips; brushes of both
versions, gray and RGBA; IM types PIL's writer does not write (`B2`, `B4`,
`X 24`, `RGB3`, `L 8`, a colour `Lut` on `B2`, an inverted gray `Lut`);
IMT headers with comments and CR LF lines; IPTC gray records, raw and
JPEG, in one (8, 10) field or several. Then PIXAR RGB; McIdas areas of 1-
and 2-byte samples, with a line prefix, of two bands (C6); XV thumbnails
with comments and CR LF lines; FITS of 8 bits, unsigned 16 bits (B32), a
cube (C7), one axis, an image extension after an empty primary and the
GZIP_1 tile form at 8 and 16 bits, each padded to 2880 bytes; PIL's own
SPIDER file (refused: float samples, B21); FTEX textures of PIL's DDS
writer's DXT1 blocks (a partial edge block), of random blocks (both BC1
modes), of `io/ftex.py`'s DXT1 and raw writers.

`digests.json` holds, per file, PIL's format and mode, the rule the port
applies to PIL's array and the SHA-256 and shape of the array the rule
gives. The rules: none; A2 LA, PA -> `convert("RGBA")`; B7 I;16 -> the
high byte; B14 CMYK, B15 palette, B30 YCbCr -> `convert("RGB")`; B16 1-bit
-> `convert("L")`; F8 (IM's `L 8`, mode F of byte values) -> its values as
bytes; B32 (FITS `I;16`: PIL reads the big-endian samples little-endian)
-> the samples byte-swapped back, as signed, + BZERO 32768, the high byte;
"B21 refused" (SPIDER's float samples): no array, the port raises.
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
OUT = os.path.join(ROOT, "tests", "data", "raw_samples")


def natural(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Smooth gradients plus seeded noise, flat patches, (h, w, c) uint8."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 11.0 - k)
                     for k in range(c)], -1)
    img = np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)
    img[h // 3:h // 2, w // 4:w // 2] = img[h // 3, w // 4]
    return img


def port_array(data: bytes) -> tuple[np.ndarray, str, str, str]:
    """PIL's array of a file with the port's rule applied -> (array, PIL's
    format, PIL's mode, the rule)."""
    from PIL import Image

    im = Image.open(io.BytesIO(data))
    fmt, mode = im.format, im.mode
    im.load()
    if fmt == "SPIDER":
        return None, fmt, mode, "B21 refused"
    if fmt == "FITS" and mode == "I;16":
        stored = np.asarray(im).astype(np.uint16).byteswap().view(np.int16)
        return ((stored.astype(np.int64) + 32768) >> 8).astype(np.uint8), fmt, mode, "B32"
    if mode in ("LA", "PA"):
        return np.asarray(im.convert("RGBA")), fmt, mode, "A2"
    if mode.startswith("I;16"):
        return (np.asarray(im).astype(np.uint16) >> 8).astype(np.uint8), fmt, mode, "B7"
    rule = {"CMYK": "B14", "P": "B15", "YCbCr": "B30"}.get(mode)
    if rule:
        return np.asarray(im.convert("RGB")), fmt, mode, rule
    if mode == "1":
        return np.asarray(im.convert("L")), fmt, mode, "B16"
    if mode == "F":
        a = np.asarray(im)
        assert (a == np.round(a)).all() and a.min() >= 0 and a.max() <= 255, "not bytes"
        return a.astype(np.uint8), fmt, mode, "F8"
    return np.asarray(im), fmt, mode, ""


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def digests(data: bytes) -> dict:
    a, fmt, mode, rule = port_array(data)
    return {"array": None if a is None else sha(a), "shape": None if a is None else
            list(a.shape), "pil_format": fmt, "pil_mode": mode, "rule": rule}


def _chunk(kind: int, body: bytes) -> bytes:
    body += b"\0" * (len(body) % 2)
    return struct.pack("<IH", 6 + len(body), kind) + body


def fli_with(data: bytes, subs: list) -> bytes:
    """An FLI file of `data`'s header with its frame's sub-chunks replaced."""
    body = b"".join(subs)
    frame = struct.pack("<IHH8x", 16 + len(body), 0xF1FA, len(subs)) + body
    head = bytearray(data[:128])
    struct.pack_into("<I", head, 0, 128 + len(frame))
    return bytes(head) + frame


def files() -> dict[str, bytes]:
    from PIL import Image

    sys.path.insert(0, ROOT)
    from gaussianmesh_tpu_torch.io import fli, gbr, im, imt, iptc

    def pil(img, fmt, mode=None, **kw):
        buf = io.BytesIO()
        (img if isinstance(img, Image.Image) else Image.fromarray(img, mode)).save(
            buf, fmt, **kw)
        return buf.getvalue()

    rgb, rgba = natural(17, 23, 3, 1), natural(19, 21, 4, 2)
    gray = rgb[..., 0]
    cmyk = natural(17, 23, 4, 3)
    wide = natural(17, 22, 3, 4)
    rng = np.random.default_rng(5)
    pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    idx = (gray // 4).astype(np.uint8)                    # 64 entries in use
    idx22 = (wide[..., 0] // 4).astype(np.uint8)
    u16 = (gray.astype(np.uint16) << 8) | rgb[..., 1]
    p_img = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE, colors=200)

    # FLI: a frame of BRUN, then BLACK, then a stamp (a frame whose last
    # chunk holds 10 bytes or more); palette packets with skips
    brun = fli.encode_fli(idx, pal)
    sub = brun[144:]
    pal_size = struct.unpack_from("<I", sub, 0)[0]
    brun_chunk = sub[pal_size:]
    stamp = _chunk(18, bytes(12))
    packets = struct.pack("<H", 2) + bytes((10, 5)) + pal[:5].tobytes() + bytes((3, 2)) \
        + pal[5:7].tobytes()
    skipped = fli_with(brun, [_chunk(4, packets), brun_chunk])
    black = fli_with(brun, [sub[:pal_size], brun_chunk, _chunk(13, b""), stamp])
    gray_ramp = fli_with(brun, [brun_chunk])           # no palette chunk: PIL's gray ramp
    out = {
        "hand_fli_brun_256_23x17.fli": brun,
        "hand_flc_brun_64_23x17.flc": fli.encode_fli(idx, pal, flc=True, levels=64),
        "hand_fli_copy_64_23x17.fli": fli.encode_fli(idx, pal, chunk="copy", levels=64),
        "hand_flc_copy_256_23x17.flc": fli.encode_fli(idx, pal, chunk="copy", flc=True),
        "hand_fli_lc_23x17.fli": fli.encode_fli(idx, pal, chunk="lc"),
        "hand_flc_ss2_22x17.flc": fli.encode_fli(idx22, pal, chunk="ss2", flc=True),
        "hand_fli_lc_skips_300x5.fli": fli.encode_fli(
            np.pad(idx[:5, :4], ((0, 0), (296, 0))), pal, chunk="lc"),
        "hand_fli_palette_skips_23x17.fli": skipped,
        "hand_fli_black_stamp_23x17.fli": black,
        "hand_fli_no_palette_23x17.fli": gray_ramp,
        "hand_gbr_v1_gray_23x17.gbr": gbr.encode_gbr(gray, version=1),
        "hand_gbr_v2_gray_23x17.gbr": gbr.encode_gbr(gray),
        "hand_gbr_v1_rgba_21x19.gbr": gbr.encode_gbr(rgba, version=1),
        "hand_gbr_v2_rgba_21x19.gbr": gbr.encode_gbr(rgba, comment=b"a longer comment"),
        "pil_im_1_b16_23x17.im": pil(Image.fromarray(gray).convert("1"), "IM"),
        "pil_im_l_23x17.im": pil(gray, "IM"),
        "pil_im_la_a2_23x17.im": pil(rgb[..., :2], "IM", "LA"),
        "pil_im_p_b15_23x17.im": pil(p_img, "IM"),
        "pil_im_pa_a2_23x17.im": pil(p_img.convert("PA"), "IM"),
        "pil_im_rgb_23x17.im": pil(rgb, "IM"),
        "pil_im_rgba_21x19.im": pil(rgba, "IM"),
        "pil_im_rgbx_23x17.im": pil(Image.fromarray(rgb).convert("RGBX"), "IM"),
        "pil_im_cmyk_b14_23x17.im": pil(cmyk, "IM", "CMYK"),
        "pil_im_ycc_b30_23x17.im": pil(rgb, "IM", "YCbCr"),
        "pil_im_i16_b7_23x17.im": pil(Image.fromarray(u16), "IM"),
        "pil_im_i16b_b7_23x17.im": pil(Image.fromarray(u16).convert("I;16B"), "IM"),
        "pil_im_i16l_b7_23x17.im": pil(Image.fromarray(u16).convert("I;16L"), "IM"),
        "hand_im_b2_b15_23x17.im": im.encode_im(gray % 4, "B2"),
        "hand_im_b4_b15_23x17.im": im.encode_im(gray % 16, "B4"),
        "hand_im_b2_colour_lut_b15_23x17.im": im.encode_im(gray, "B2", lut=pal),
        "hand_im_grey_inverted_lut_c4_23x17.im": im.encode_im(
            gray, "L", lut=np.repeat(np.arange(255, -1, -1, dtype=np.uint8)[:, None], 3, 1)),
        "hand_im_x24_23x17.im": im.encode_im(rgb, "X24"),
        "hand_im_rgb3_c5_23x17.im": im.encode_im(rgb, "RGB3"),
        "hand_im_l8_f8_23x17.im": im.encode_im(gray, "L8"),
        "hand_imt_23x17.imt": imt.encode_imt(gray),
        "hand_imt_crlf_comments_23x17.imt": (
            b"*image\r\n*another comment\r\nwidth 23\r\nheight 17\r\npixel n8\r\n\x0c"
            + gray.tobytes()),
        "hand_iptc_raw_gray_23x17.iim": iptc.encode_iptc(gray),
        "hand_iptc_raw_gray_fields_23x17.iim": iptc.encode_iptc(gray, chunk=100),
        "hand_iptc_jpeg_gray_23x17.iim": iptc.encode_iptc(gray, "jpeg"),
    }
    out.update(raw_sample_files(rgb, u16, pil))
    return out


def raw_sample_files(rgb: np.ndarray, u16: np.ndarray, pil) -> dict[str, bytes]:
    """The PIXAR, MCIDAS, XV thumbnail, FITS, SPIDER and FTEX fixtures of
    the 23 x 17 `rgb` and 16-bit `u16` images (`pil(img, fmt, mode)` saves
    through PIL)."""
    from PIL import Image

    from gaussianmesh_tpu_torch.io import fits, ftex, mcidas, pixar, xvthumb

    gray = rgb[..., 0]
    small = rgb[:6, :7]
    dds = pil(small, "DDS", pixel_format="DXT1")
    dds23 = pil(rgb, "DDS", pixel_format="DXT1")

    def texture(w, h, fmt, body):
        return (b"FTEX" + struct.pack("<i2i2i2i", 1, w, h, 1, 1, fmt, 32)
                + struct.pack("<i", len(body)) + body)
    random_blocks = np.random.default_rng(6).integers(0, 256, (12, 8), dtype=np.uint8)
    random_blocks[::2, 2:4] = random_blocks[::2, 0:2]          # c0 == c1: three colours
    card, unit = fits._card, fits._unit

    def image_unit(first, naxes, body):
        cards = [first, card("BITPIX", 8), card("NAXIS", len(naxes))]
        cards += [card(f"NAXIS{k + 1}", n) for k, n in enumerate(naxes)]
        out = unit(cards) + body
        return out + bytes(-len(out) % 2880)
    simple = card("SIMPLE", True)
    planes = np.concatenate([gray[::-1], 255 - gray[::-1], gray[::-1] // 2]).tobytes()
    empty = unit([simple, card("BITPIX", 8), card("NAXIS", 0), card("EXTEND", True)])
    return {
        "hand_pixar_rgb_23x17.pxr": pixar.encode_pixar(rgb),
        "hand_mcidas_1byte_23x17.mcidas": mcidas.encode_mcidas(gray),
        "hand_mcidas_2byte_b7_23x17.mcidas": mcidas.encode_mcidas(u16, size=2),
        "hand_mcidas_prefix_23x17.mcidas": mcidas.encode_mcidas(gray, prefix=4),
        "hand_mcidas_2bands_c6_23x17.mcidas": mcidas.encode_mcidas(u16, size=2, bands=2),
        "hand_xvthumb_b15_23x17.xv": xvthumb.encode_xvthumb(xvthumb.rgb332(rgb)),
        "hand_xvthumb_crlf_comments_23x17.xv": (
            b"P7 332 \r\n#XVVERSION:Version 2.28\r\n#BUILTIN:STIPPLE\r\n23 17 255\r\n"
            + xvthumb.rgb332(rgb[:, ::-1]).tobytes()),
        "hand_fits_8bit_23x17.fits": fits.encode_fits(gray),
        "hand_fits_16bit_unsigned_b32_23x17.fits": fits.encode_fits(u16),
        "hand_fits_cube_c7_23x17.fits": image_unit(simple, (23, 17, 3), planes),
        "hand_fits_naxis1_1x17.fits": image_unit(simple, (17,), gray[::-1, 0].tobytes()),
        "hand_fits_xtension_image_23x17.fits": empty + image_unit(
            card("XTENSION", "IMAGE"), (23, 17), gray[::-1].tobytes()),
        "hand_fits_gzip8_23x17.fits": fits.encode_fits(gray, compress=True),
        "hand_fits_gzip16_unsigned_b32_23x17.fits": fits.encode_fits(u16, compress=True),
        "pil_spider_b21_23x17.spi": pil(Image.fromarray(gray).convert("F"), "SPIDER"),
        "pil_dds_dxt1_ftex_7x6.ftc": texture(7, 6, 0, dds[128:]),
        "pil_dds_dxt1_ftex_23x17.ftc": texture(23, 17, 0, dds23[128:]),
        "hand_ftex_random_blocks_13x9.ftc": texture(13, 9, 0, random_blocks.tobytes()),
        "hand_ftex_dxt1_23x17.ftc": ftex.encode_ftex(rgb)[0],
        "hand_ftex_raw_23x17.ftu": ftex.encode_ftex(rgb, ftex.UNCOMPRESSED)[0],
        "hand_ftex_raw_to_the_end_23x17.ftu": (  # a length of -1: the rest of the file
            texture(23, 17, 1, b"")[:-4] + struct.pack("<i", -1) + rgb.tobytes()),
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
