"""Writes the DDS and BLP fixtures of `tests/data/textures/` and their
digests, for the tests and `chip_smoke.py`'s phase 9m (the card's machine
has no PIL to check the port's readers against).

    python tools/make_texture_fixtures_torch.py [--out tests/data/textures]

Runs only where PIL is installed. The `pil_*` files are PIL-written: its
DDS writer's DXT1, DXT3, DXT5, BC2, BC3 and BC5 blocks and its L, LA, RGB
and RGBA (masked) textures; its BLP writer's BLP1 and BLP2 palettes. The
`hand_*` files are written by the port's writers (`io/bcn.py`,
`io/dds.py`, `io/blp.py`) or from random blocks here: DDS BC4 under each
of its names, BC5 and BC5S, DX10 BC1 / BC4 / BC5 snorm, BC7 of mode 6 and
of random blocks forced into each of the eight modes and the reserved one,
16-bit masks with and without alpha, a palette, R8G8B8A8; the BC6H forms
(refused); a 565 texture cut short (B34, refused); BLP1 JPEGs of one,
three and four (B35) components, BLP2 DXT1 / DXT3 / DXT5 of both alpha
depths (B36), of width 2 (B37), and BLP2's raw BGRA (refused).

`digests.json` holds, per file, PIL's format and mode, the rule the port
applies and the SHA-256 and shape of the array the rule gives. The rules:
none; A2 LA -> `convert("RGBA")`; B15 P -> `convert("RGB")`; B35 a
four-component BLP1 JPEG -> the JPEG's components as stored (255 minus
PIL's samples of the JPEG alone, which PIL opens inverted, `CMYK;I`)
taken as B, G, R, A; B36 BLP2 DXT3 / DXT5 of alpha depth 0 -> PIL's
reading of the file at alpha depth 8, the alpha dropped; B37 BLP2 DXT of a width not a
multiple of 4 -> PIL's reading of the same blocks at the width rounded up,
cropped; "B34 refused" and "refused" (BC6H, BLP2's raw BGRA): no array,
the port raises.
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
OUT = os.path.join(ROOT, "tests", "data", "textures")
sys.path.insert(0, ROOT)

from tools.make_raw_sample_fixtures_torch import digests, natural, sha  # noqa: E402


def random_bc7(n: int, seed: int) -> np.ndarray:
    """n random BC7 blocks, block k forced into mode k % 9 (8: the reserved
    mode, a first byte of 0)."""
    blocks = np.random.default_rng(seed).integers(0, 256, (n, 16), dtype=np.uint8)
    for k in range(n):
        m = k % 9
        blocks[k, 0] = 0 if m == 8 else (int(blocks[k, 0]) << (m + 1) | 1 << m) & 255
    return blocks


def blp2_head(w: int, h: int, encoding: int, alpha: int, alpha_encoding: int, body: bytes,
              palette: bytes = bytes(1024)) -> bytes:
    """A BLP2 texture of mipmap 0 `body` after `palette`."""
    head = b"BLP2" + struct.pack("<i3bx", 1, encoding, alpha, alpha_encoding)
    head += struct.pack("<II", w, h)
    first = len(head) + 128 + len(palette)
    return (head + struct.pack("<16I", first, *[0] * 15)
            + struct.pack("<16I", len(body), *[0] * 15) + palette + body)


def blp1_jpeg(w: int, h: int, alpha: int, stream: bytes) -> bytes:
    """A BLP1 JPEG texture: the stream's markers before its scan as the
    shared header, the scan as mipmap 0."""
    sos = stream.index(b"\xff\xda")
    head = b"BLP1" + struct.pack("<iIIIii", 0, alpha, w, h, 5, 0)
    first = len(head) + 128 + 4 + sos
    return (head + struct.pack("<16I", first, *[0] * 15)
            + struct.pack("<16I", len(stream) - sos, *[0] * 15)
            + struct.pack("<I", sos) + stream)


def files() -> dict[str, tuple[bytes, dict | None]]:
    """{name: (bytes, None, or the digest of a B rule's oracle)}."""
    from PIL import Image

    from gaussianmesh_tpu_torch.io import bcn, blp, dds, jpeg

    def pil(img, fmt, mode=None, **kw):
        buf = io.BytesIO()
        (img if isinstance(img, Image.Image) else Image.fromarray(img, mode)).save(
            buf, fmt, **kw)
        return buf.getvalue()

    def oracle(a, fmt, mode, rule):
        return {"array": sha(a), "shape": list(a.shape), "pil_format": fmt,
                "pil_mode": mode, "rule": rule}

    def refused(data, rule):
        im = Image.open(io.BytesIO(data))
        return {"array": None, "shape": None, "pil_format": im.format, "pil_mode": im.mode,
                "rule": rule}

    rgb, rgba = natural(17, 23, 3, 1), natural(17, 23, 4, 2)
    gray = rgb[..., 0]
    rng = np.random.default_rng(3)
    head = dds.dds_head
    fourcc, rgbf, alpha = dds.FOURCC, dds.RGB, dds.ALPHAPIXELS
    out = {}
    for pf in ("DXT1", "DXT3", "DXT5", "BC2", "BC3"):
        out[f"pil_dds_{pf.lower()}_23x17.dds"] = pil(rgba, "DDS", pixel_format=pf)
    out["pil_dds_dxt1_7x6.dds"] = pil(rgba[:6, :7], "DDS", pixel_format="DXT1")
    out["pil_dds_bc5_23x17.dds"] = pil(rgb, "DDS", pixel_format="BC5")
    out["pil_dds_l_23x17.dds"] = pil(gray, "DDS")
    out["pil_dds_la_a2_23x17.dds"] = pil(rgba[..., :2], "DDS", "LA")
    out["pil_dds_rgb_23x17.dds"] = pil(rgb, "DDS")
    out["pil_dds_rgba_23x17.dds"] = pil(rgba, "DDS")

    bc4, _ = bcn.encode_bc4(gray)
    bc5, _ = bcn.encode_bc5(rgb)
    bc5s = rng.integers(0, 256, (bcn.bc1_blocks(23, 17), 16), dtype=np.uint8).tobytes()
    bc7_blocks = random_bc7(bcn.bc1_blocks(13, 9), 4)
    bc1_blocks = rng.integers(0, 256, (bcn.bc1_blocks(13, 9), 8), dtype=np.uint8)
    bc1_blocks[::3, 2:4] = bc1_blocks[::3, 0:2]              # the three-colour mode too
    c = rgba.astype(np.uint32)
    argb1555 = ((c[..., 3] >> 7) << 15 | (c[..., 0] >> 3) << 10 | (c[..., 1] >> 3) << 5
                | c[..., 2] >> 3).astype("<u2").tobytes()
    gapped = (c[..., 0] << 16 | c[..., 1] << 4).astype("<u4").tobytes()
    palette = rng.integers(0, 256, (256, 4), dtype=np.uint8)
    out.update({
        "hand_dds_bc4u_23x17.dds": head(23, 17, fourcc, b"BC4U") + bc4,
        "hand_dds_ati1_23x17.dds": head(23, 17, fourcc, b"ATI1") + bc4,
        "hand_dds_dx10_bc4_23x17.dds": head(23, 17, fourcc, b"DX10", dxgi=80) + bc4,
        "hand_dds_bc5u_23x17.dds": head(23, 17, fourcc, b"BC5U") + bc5,
        "hand_dds_ati2_23x17.dds": head(23, 17, fourcc, b"ATI2") + bc5,
        "hand_dds_bc5s_random_23x17.dds": head(23, 17, fourcc, b"BC5S") + bc5s,
        "hand_dds_dx10_bc5_snorm_random_23x17.dds": head(23, 17, fourcc, b"DX10", dxgi=84)
        + bc5s,
        "hand_dds_dx10_bc1_random_13x9.dds": head(13, 9, fourcc, b"DX10", dxgi=71)
        + bc1_blocks.tobytes(),
        "hand_dds_dx10_bc7_mode6_23x17.dds": dds.encode_dds(rgba, "BC7")[0],
        "hand_dds_dx10_bc7_every_mode_13x9.dds": head(13, 9, fourcc, b"DX10", dxgi=97)
        + bc7_blocks.tobytes(),
        "hand_dds_dx10_bc7_srgb_every_mode_13x9.dds": head(13, 9, fourcc, b"DX10", dxgi=99)
        + random_bc7(bcn.bc1_blocks(13, 9), 5).tobytes(),
        "hand_dds_dxt1_writer_23x17.dds": dds.encode_dds(rgb, "DXT1")[0],
        "hand_dds_dxt5_writer_23x17.dds": dds.encode_dds(rgba, "DXT5")[0],
        "hand_dds_rgb565_23x17.dds": dds.encode_dds(rgb, "RGB565")[0],
        "hand_dds_argb1555_23x17.dds": head(23, 17, rgbf | alpha, bitcount=16,
                                            masks=(0x7C00, 0x03E0, 0x001F, 0x8000))
        + argb1555,
        "hand_dds_gapped_masks_23x17.dds": head(23, 17, rgbf, bitcount=32,
                                                masks=(0xFF0000, 0xFF0, 0, 0)) + gapped,
        "hand_dds_palette_b15_23x17.dds": head(23, 17, dds.PALETTEINDEXED8, bitcount=8)
        + palette.tobytes() + gray.tobytes(),
        "hand_dds_dx10_r8g8b8a8_23x17.dds": head(23, 17, fourcc, b"DX10", dxgi=28)
        + rgba.tobytes(),
    })
    b16 = rng.integers(0, 256, bcn.bc1_blocks(8, 8) * 16, dtype=np.uint8).tobytes()
    rules = {
        "hand_dds_dx10_bc6h_uf16_8x8.dds": (head(8, 8, fourcc, b"DX10", dxgi=95) + b16,
                                            "refused"),
        "hand_dds_dx10_bc6h_sf16_8x8.dds": (head(8, 8, fourcc, b"DX10", dxgi=96) + b16,
                                            "refused"),
        "hand_dds_rgb565_cut_b34_23x17.dds": (dds.encode_dds(rgb, "RGB565")[0][:-101],
                                              "B34 refused"),
    }
    out.update({k: (v[0], refused(*v)) for k, v in rules.items()})

    # BLP: PIL's palettes, the port's JPEG and DXT forms, B35-B37
    p_img = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE, colors=200)
    out["pil_blp2_palette_23x17.blp"] = pil(p_img, "BLP")
    out["pil_blp1_palette_23x17.blp"] = pil(p_img, "BLP", blp_version="BLP1")
    out["pil_blp2_palette_rgba_23x17.blp"] = pil(Image.fromarray(rgba).convert("P"), "BLP")
    pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    out["hand_blp2_palette_writer_23x17.blp"] = blp.encode_blp(gray, "BLP2_PALETTE",
                                                               palette=pal)[0]
    out["hand_blp1_jpeg_writer_23x17.blp"] = blp.encode_blp(rgb, "BLP1_JPEG")[0]
    out["hand_blp1_jpeg_gray_23x17.blp"] = blp1_jpeg(23, 17, 0, jpeg.encode_jpeg(gray))
    out["hand_blp1_jpeg_alpha8_23x17.blp"] = blp1_jpeg(23, 17, 8, jpeg.encode_jpeg(
        np.ascontiguousarray(rgb[..., ::-1]), subsampling="4:4:4"))
    bgra = np.ascontiguousarray(rgba[..., [2, 1, 0, 3]])
    four = jpeg.encode_jpeg(bgra, subsampling="4:4:4", color="as_is")
    # PIL opens every CMYK JPEG inverted (`CMYK;I`): the components as stored
    planes = 255 - np.asarray(Image.open(io.BytesIO(four)))
    for a in (8, 0):
        want = planes[..., [2, 1, 0, 3]][..., :4 if a else 3]
        out[f"hand_blp1_jpeg_bgra_b35_alpha{a}_23x17.blp"] = (
            blp1_jpeg(23, 17, a, four),
            oracle(np.ascontiguousarray(want), "BLP", "RGBA" if a else "RGB", "B35"))
    for enc, kind, name in ((0, bcn.BC1, "dxt1"), (1, bcn.BC2, "dxt3"), (7, bcn.BC3, "dxt5")):
        blocks = rng.integers(0, 256, (bcn.bc1_blocks(24, 16), bcn.BLOCK_BYTES[kind]),
                              dtype=np.uint8)
        blocks[::3, 2:4] = blocks[::3, 0:2]
        body = blocks.tobytes()
        out[f"hand_blp2_{name}_alpha8_24x16.blp"] = blp2_head(24, 16, 2, 8, enc, body)
        if enc:                                                  # B36
            full = np.asarray(Image.open(io.BytesIO(blp2_head(24, 16, 2, 8, enc, body))))
            out[f"hand_blp2_{name}_alpha0_b36_24x16.blp"] = (
                blp2_head(24, 16, 2, 0, enc, body),
                oracle(np.ascontiguousarray(full[..., :3]), "BLP", "RGB", "B36"))
        else:
            out[f"hand_blp2_{name}_alpha0_24x16.blp"] = blp2_head(24, 16, 2, 0, enc, body)
    for w, h in ((2, 8), (6, 5)):                                 # B37
        body = bcn.encode_bc1(rgb[:h, :w])[0]
        wide = np.asarray(Image.open(io.BytesIO(blp2_head(4 * ((w + 3) // 4), h, 2, 0, 0,
                                                          body))))
        out[f"hand_blp2_dxt1_width{w}_b37_{w}x{h}.blp"] = (
            blp2_head(w, h, 2, 0, 0, body),
            oracle(np.ascontiguousarray(wide[:, :w]), "BLP", "RGB", "B37"))
    raw = blp2_head(4, 4, 3, 8, 0, rgba[:4, :4].tobytes())
    out["hand_blp2_raw_bgra_4x4.blp"] = (raw, refused(raw, "refused"))
    return {k: v if isinstance(v, tuple) else (v, None) for k, v in out.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    table = {}
    for name, (data, digest) in files().items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        table[name] = digest or digests(data)
    with open(os.path.join(args.out, "digests.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({"files": len(table), "bytes": sum(
        os.path.getsize(os.path.join(args.out, n)) for n in table)}))


if __name__ == "__main__":
    main()
