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
16-bit masks with and without alpha, a palette, R8G8B8A8; DX10 BC6H
unsigned and signed (DXGI 95, 96) of random blocks (`random_bc6h`: every
mode and the reserved ones, the signed transformed ones made so that no
endpoint is negative, where PIL reads them right), of `encode_bc6h`, and
of fault B38 (signed blocks whose weights each take one endpoint); a 565
texture cut short (B34, refused); BLP1 JPEGs of one,
three and four (B35) components, BLP2 DXT1 / DXT3 / DXT5 of both alpha
depths (B36), of width 2 (B37), and BLP2's raw BGRA (refused).

`digests.json` holds, per file, PIL's format and mode, the rule the port
applies and the SHA-256 and shape of the array the rule gives. The rules:
none; A2 LA -> `convert("RGBA")`; B15 P -> `convert("RGB")`; B38 BC6HS
blocks of a transformed mode whose every weight is 0 or 64 -> each pixel
PIL's reading of a signed mode-0x0F block (16-bit endpoints, which PIL
sign-extends right, and which unquantize as they are) holding that
pixel's endpoint as the definition unquantizes it; B35 a
four-component BLP1 JPEG -> the JPEG's components as stored (255 minus
PIL's samples of the JPEG alone, which PIL opens inverted, `CMYK;I`)
taken as B, G, R, A; B36 BLP2 DXT3 / DXT5 of alpha depth 0 -> PIL's
reading of the file at alpha depth 8, the alpha dropped; B37 BLP2 DXT of a width not a
multiple of 4 -> PIL's reading of the same blocks at the width rounded up,
cropped; "B34 refused" and "refused" (BLP2's raw BGRA): no array, the
port raises.
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


def random_bc6h(n: int, seed: int, signed: bool, first: int = 0) -> np.ndarray:
    """n random BC6H blocks, block k forced into mode pattern (first + k) %
    18 of `bcn.BC6H_MODES + bcn.BC6H_RESERVED`. Signed blocks of a
    transformed mode of under 16 bits are built field by field so that no
    endpoint is negative (PIL reads the others unsigned: fault B38); the
    rest are random bytes under the mode's bits."""
    from gaussianmesh_tpu_torch.io import bcn

    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    patterns = bcn.BC6H_MODES + bcn.BC6H_RESERVED
    for k in range(n):
        value = patterns[(first + k) % len(patterns)]
        blocks[k, 0] = (blocks[k, 0] & (0xFC if value < 2 else 0xE0)) | value
        if not signed or value not in bcn.BC6H_MODES:
            continue
        _, _, ns, transformed, bits, delta, _ = bcn._BC6H_MODES[bcn.BC6H_MODES.index(value)]
        if not transformed or bits >= 16:
            continue
        fields = np.zeros(12, np.int64)
        fields[:3] = rng.integers(0, 1 << (bits - 1), 3)
        for e in range(3, 6 * ns):
            d, w = delta[e % 3], int(fields[e % 3])
            lo, hi = max(-w, -(1 << (d - 1))), min((1 << (bits - 1)) - 1 - w, (1 << (d - 1)) - 1)
            fields[e] = int(rng.integers(lo, hi + 1)) & ((1 << d) - 1)
        part = int(rng.integers(0, 32))
        idx = rng.integers(0, 8 if ns == 2 else 16, 16)
        idx[bcn._anchor(ns, np.array([part]))[0]] &= 3 if ns == 2 else 7
        blocks[k] = bcn.bc6h_block(value, fields[None], part, idx[None])[0]
    return blocks


def _bc6h_parts(b: np.ndarray):
    """A BC6H block of a defined mode -> (its mode's row of
    `bcn._BC6H_MODES`, its stored fields (1, 12), partition, indices (16,))."""
    from gaussianmesh_tpu_torch.io import bcn

    two = b[0] & 3
    mode = bcn._BC6H_MODES[bcn.BC6H_MODES.index(int(two if two < 2 else b[0] & 31))]
    raw = np.unpackbits(b[None], axis=1, bitorder="little").astype(np.int64)
    fields = bcn.bc6h_stored(b[None], mode[0])
    ns = mode[2]
    part = int(bcn._read(raw, np.full((1, 1), 77), np.full((1, 1), 5))[0, 0]) if ns == 2 else 0
    widths = (3 if ns == 2 else 4) - bcn._anchor(ns, np.array([part]))
    idx = bcn._read(raw, (82 if ns == 2 else 65) + np.cumsum(widths, 1) - widths, widths)[0]
    return mode, fields, part, idx


def b38_blocks(blocks: np.ndarray) -> np.ndarray:
    """BC6H blocks of defined modes -> the same blocks with each index made
    0 or the largest at random (anchors 0), so that each pixel takes one
    endpoint: fault B38's blocks."""
    from gaussianmesh_tpu_torch.io import bcn

    rng = np.random.default_rng(38)
    out = blocks.copy()
    for k, b in enumerate(blocks):
        mode, fields, part, _ = _bc6h_parts(b)
        ns = mode[2]
        top = rng.integers(0, 2, 16).astype(bool) & ~bcn._anchor(ns, np.array([part]))[0]
        out[k] = bcn.bc6h_block(mode[0], fields, part, np.where(top, 7 if ns == 2 else 15,
                                                                  0)[None])[0]
    return out


def b38_oracle(blocks: np.ndarray, w: int, h: int) -> np.ndarray:
    """Signed BC6H blocks whose indices are each 0 or the largest, as a w x
    h texture -> fault B38's oracle: each pixel PIL's reading of a signed
    mode-0x0F block (16-bit endpoints, which unquantize as they are and
    which PIL sign-extends right) holding that pixel's endpoint as the
    definition unquantizes it."""
    from PIL import Image

    from gaussianmesh_tpu_torch.io import bcn

    n = len(blocks)
    ends, slots = np.zeros((n, 12), np.int64), np.zeros((n, 16, 3), np.int64)
    for k, b in enumerate(blocks):
        mode, _, part, idx = _bc6h_parts(b)
        ends[k] = bcn._bc6h_unquantize(bcn.bc6h_endpoints(b[None], mode[0], True)[0],
                                       mode[4], True)
        region = (bcn.BC7_PARTITIONS2[part] >> np.arange(16)) & 1 if mode[2] == 2 else 0
        slots[k] = 3 * (2 * region + (idx > 0))[:, None] + np.arange(3)
    fields = np.zeros((12 * n, 12), np.int64)
    fields[:, :3] = (ends.reshape(-1, 1) & 0xFFFF).repeat(3, 1)
    one = bcn.bc6h_block(0x0F, fields, 0, np.zeros((12 * n, 16), np.int64))
    read = np.asarray(Image.frombytes("RGB", (48 * n, 4), one.tobytes(), "bcn", (6, "BC6HS")))
    level = read[0, ::4, 0].reshape(n, 12)              # each endpoint's 8-bit reading
    px = np.take_along_axis(np.repeat(level[:, None, :], 16, 1), slots, 2)
    bw = (w + 3) // 4
    tiles = px.reshape(-1, bw, 4, 4, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 4 * bw, 3)
    return np.ascontiguousarray(tiles[:h, :w].astype(np.uint8))


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
    out["hand_dds_dx10_bc6h_uf16_8x8.dds"] = head(8, 8, fourcc, b"DX10", dxgi=95) + b16
    out["hand_dds_dx10_bc6h_sf16_8x8.dds"] = head(8, 8, fourcc, b"DX10", dxgi=96) + \
        random_bc6h(4, 6, True, first=9).tobytes()
    for (w, h), first in (((13, 9), 6), ((23, 17), 0)):
        for dxgi, sign in ((95, "uf16"), (96, "sf16")):
            out[f"hand_dds_dx10_bc6h_{sign}_every_mode_{w}x{h}.dds"] = head(
                w, h, fourcc, b"DX10", dxgi=dxgi) + random_bc6h(
                bcn.bc1_blocks(w, h), w + dxgi, dxgi == 96, first).tobytes()
    out["hand_dds_dx10_bc6h_uf16_writer_23x17.dds"] = dds.encode_dds(rgb, "BC6H")[0]
    out["hand_dds_dx10_bc6h_sf16_writer_23x17.dds"] = dds.encode_dds(rgb, "BC6HS")[0]
    # B38: random signed blocks of the transformed modes, each weight 0 or 64
    transformed = [v for v, _, _, t, bits, _, _ in bcn._BC6H_MODES if t and bits < 16]
    raw = np.random.default_rng(38).integers(0, 256, (bcn.bc1_blocks(23, 17), 16),
                                             dtype=np.uint8)
    for k in range(len(raw)):
        value = transformed[k % len(transformed)]
        raw[k, 0] = (raw[k, 0] & (0xFC if value < 2 else 0xE0)) | value
    b38 = b38_blocks(raw)
    out["hand_dds_dx10_bc6h_sf16_b38_23x17.dds"] = (
        head(23, 17, fourcc, b"DX10", dxgi=96) + b38.tobytes(),
        oracle(b38_oracle(b38, 23, 17), "DDS", "RGB", "B38"))
    rules = {
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
