"""PNG images with `zlib` and `struct` alone: the machines the port runs on
need no imaging package (the JAX package reads images with PIL and writes
them with imageio).

`read_png` decodes every PNG PIL reads (gray, gray + alpha, RGB, RGBA and
palette; 1- to 16-bit samples; the five row filters None, Sub, Up, Average
and Paeth; Adam7 interlace) to uint8 arrays: (H, W) for gray, (H, W, C)
otherwise. 16-bit samples keep their high byte and palette images expand
to RGB or RGBA (the JAX reader's PIL path gives 16-bit gray unscaled and
palette indices). `read_image` reads a JPEG (`io/jpeg.py`), a PNG, a BMP
or DIB (`io/bmp.py`), a TIFF (`io/tiff.py`), a GIF (`io/gif.py`), a WebP
(`io/webp.py`: lossy, lossless, with alpha, an animation's first frame), a
PNM (`io/pnm.py`), a QOI (`io/qoi.py`), an SGI (`io/sgi.py`), a PCX or
DCX (`io/pcx.py`), an ICO or CUR (`io/ico.py`), an ICNS (`io/icns.py`), an
MSP (`io/msp.py`), a PSD (`io/psd.py`), a Sun raster (`io/sun.py`), an XBM
(`io/xbm.py`), an XPM (`io/xpm.py`), an FLI or FLC (`io/fli.py`), a GIMP
brush (`io/gbr.py`), an IM (`io/im.py`), an IMT (`io/imt.py`), an IPTC
(`io/iptc.py`), a PIXAR (`io/pixar.py`), a McIdas area (`io/mcidas.py`),
an XV thumbnail (`io/xvthumb.py`), a FITS (`io/fits.py`), an FTEX
(`io/ftex.py`), a DDS (`io/dds.py`), a BLP (`io/blp.py`) or a TGA
(`io/tga.py`) by its first bytes, in PIL's order
of formats, a file PIL gives way on handed to the next format; IM, IMT,
IPTC and SPIDER (`io/spider.py`, refused where PIL opens it) (no
`_accept`) and TGA (no magic) as PIL tries them. `encode_png` encodes 8-bit
gray, gray + alpha, RGB and RGBA with filter type 0 on every row, and
`write_png` writes what it returns.

The row filters are undone by the port's C++ (`gm_png_unfilter` of
`csrc/image.cpp`, built by `ops/_cuda.py::host_library` at first use; a
failed build raises). `decode_png_plain` undoes them in numpy instead
(`_unfilter_plain`), the version the C++ is held to byte for byte; the
training path never calls it.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from gaussianmesh_tpu_torch.io import icns, ico
from gaussianmesh_tpu_torch.io.blp import BLP_MAGICS, read_blp
from gaussianmesh_tpu_torch.io.dds import DDS_MAGIC, read_dds
from gaussianmesh_tpu_torch.io.fits import fits_accept, read_fits
from gaussianmesh_tpu_torch.io.fli import fli_accept, read_fli
from gaussianmesh_tpu_torch.io.ftex import FTEX_MAGIC, read_ftex
from gaussianmesh_tpu_torch.io.gbr import gbr_accept, read_gbr
from gaussianmesh_tpu_torch.io.bmp import BMP_MAGIC, dib_accept, read_bmp, read_dib
from gaussianmesh_tpu_torch.io.gif import GIF_MAGICS, read_gif
from gaussianmesh_tpu_torch.io.giveway import GiveWay
from gaussianmesh_tpu_torch.io.im import read_im
from gaussianmesh_tpu_torch.io.imt import read_imt
from gaussianmesh_tpu_torch.io.iptc import read_iptc
from gaussianmesh_tpu_torch.io.jpeg import JPEG_MAGIC, read_jpeg
from gaussianmesh_tpu_torch.io.mcidas import mcidas_accept, read_mcidas
from gaussianmesh_tpu_torch.io.msp import MSP_MAGICS, read_msp
from gaussianmesh_tpu_torch.io.pcx import DCX_MAGIC, pcx_accept, read_dcx, read_pcx
from gaussianmesh_tpu_torch.io.pixar import PIXAR_MAGIC, read_pixar
from gaussianmesh_tpu_torch.io.pnm import PAM_REFUSED, is_pnm, magic_of, read_pnm
from gaussianmesh_tpu_torch.io.psd import PSD_MAGIC, read_psd
from gaussianmesh_tpu_torch.io.qoi import QOI_MAGIC, read_qoi
from gaussianmesh_tpu_torch.io.sgi import SGI_MAGIC, read_sgi
from gaussianmesh_tpu_torch.io.spider import read_spider
from gaussianmesh_tpu_torch.io.sun import SUN_MAGIC, read_sun
from gaussianmesh_tpu_torch.io.tga import read_tga, tga_header
from gaussianmesh_tpu_torch.io.tiff import TIFF_HEADS, read_tiff
from gaussianmesh_tpu_torch.io.webp import read_webp
from gaussianmesh_tpu_torch.io.xbm import read_xbm, xbm_accept
from gaussianmesh_tpu_torch.io.xpm import XPM_MAGIC, read_xpm
from gaussianmesh_tpu_torch.io.xvthumb import read_xvthumb, xvthumb_accept
from gaussianmesh_tpu_torch.ops import _cuda

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# channels -> PNG color type, for the 8-bit types `write_png` writes
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) gray or (H, W, C) uint8, C in 1-4 (gray, gray + alpha, RGB,
    RGBA) -> the bytes of an 8-bit PNG (filter 0, one zlib stream)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes 1-4 channels, not {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, c * w)], 1)
    return (PNG_MAGIC
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c],
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """`encode_png(img)` written to `path` (its directory made if needed)."""
    data = encode_png(img)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def _unfilter_plain(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters in numpy. rows (H, 1 + row bytes): each row's
    filter type, then its filtered bytes; `bpp` the byte distance to the
    left neighbour -> (H, row bytes) uint8. Each byte's predictor reads its
    left, upper and upper-left neighbours' reconstructed values, so the
    decode walks anti-diagonals x + y = d (every cell of one diagonal
    depends only on earlier diagonals), vectorised over each diagonal's
    cells."""
    ft = rows[:, 0]
    if ft.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(ft.max())}")
    raw = rows[:, 1:].reshape(len(rows), -1, bpp)
    h, w, c = raw.shape
    if not ft.any():
        return raw.reshape(h, w * c)
    out = np.zeros((h + 1, w + 1, c), np.int32)       # a zero row and column
    ftc = ft.astype(np.int32)[:, None]
    src = raw.astype(np.int32)
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(d, h - 1) + 1)
        x = d - y
        a = out[y + 1, x]                             # left
        b = out[y, x + 1]                             # up
        cc = out[y, x]                                # up-left
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        f = ftc[y]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (src[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(h, w * c)


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """`_unfilter_plain` in `csrc/image.cpp` (`gm_png_unfilter`): row after
    row, as libpng."""
    rows = np.ascontiguousarray(rows)
    out = np.empty((rows.shape[0], rows.shape[1] - 1), np.uint8)
    if _cuda.host_library("image").gm_png_unfilter(
            rows.ctypes.data, out.shape[0], out.shape[1], bpp, out.ctypes.data):
        raise ValueError(f"unknown PNG filter type {int(rows[:, 0].max())}")
    return out


# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _samples(rows: np.ndarray, width: int, depth: int, c: int) -> np.ndarray:
    """Unfiltered rows (H, row bytes) -> (H, width, c) samples, uint8: the
    high byte of a 16-bit sample, a 1/2/4-bit sample as its value."""
    h = rows.shape[0]
    if depth == 8:
        return rows.reshape(h, width, c)
    if depth == 16:
        return rows.reshape(h, width, c, 2)[..., 0]
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :width]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]


def read_png(path: str) -> np.ndarray:
    """A PNG -> uint8 (H, W) for gray, (H, W, C) otherwise, as PIL reads it:
    gray, gray + alpha, RGB and RGBA at 8 bits as they are; at 16 bits the
    high byte of each sample (PIL's rule for 16-bit RGB(A), and for gray +
    alpha, which it opens as RGBA; it gives 16-bit gray as values up to
    65,535, which the JAX reader divides by 255);
    1/2/4-bit gray scaled to 0..255, as PIL's `convert("L")`; palette
    images expanded to RGB, or RGBA where a tRNS chunk gives alpha, as
    PIL's `convert("RGB" / "RGBA")` (the JAX reader takes the indices).
    Row filters 0-4, with or without Adam7 interlace."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_png` of a PNG's bytes (`path` names it in errors)."""
    return _decode(data, path, _unfilter)


def decode_png_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_png` with the rows unfiltered in numpy (the plain version)."""
    return _decode(data, path, _unfilter_plain)


def _decode(data: bytes, path: str, unfilter) -> np.ndarray:
    if data[:8] != PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header, plte, trns = 8, [], None, None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: {tag!r} chunk fails its CRC")
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    if color_type not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG color type {color_type} is unknown")
    if depth not in _DEPTHS[color_type]:
        raise ValueError(f"{path}: {depth}-bit samples are not allowed for PNG "
                         f"color type {color_type}")
    if color_type == 3 and plte is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    c = _PNG_CHANNELS[color_type]
    bpp = max(1, depth * c // 8)                      # filter byte distance
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = np.zeros((h, w, c), np.uint8)
    pos = 0
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        row_bytes = -(-pw * depth * c // 8)
        rows = raw[pos:pos + ph * (row_bytes + 1)].reshape(ph, row_bytes + 1)
        pos += ph * (row_bytes + 1)
        img[y0::dy, x0::dx] = _samples(unfilter(rows, bpp), pw, depth, c)
    if color_type == 3:
        pal = np.zeros((256, 4), np.uint8)
        pal[:len(plte), :3] = plte
        pal[:, 3] = 255
        if trns is not None:
            pal[:len(trns), 3] = trns
        return np.ascontiguousarray(pal[img[..., 0], :3 if trns is None else 4])
    if color_type == 0 and depth < 8:
        img = img * np.uint8(255 // ((1 << depth) - 1))
    if color_type == 4 and depth == 16:               # PIL opens it as RGBA
        img = img[..., [0, 0, 0, 1]]
        c = 4
    return img[..., 0].copy() if c == 1 else np.ascontiguousarray(img)


# PIL plugins tried before TGA (it has no magic) that take some headers TGA's
# checks pass, and that the port does not read: (format, its `_accept`)
_BEFORE_TGA = (
    ("MPEG", lambda h: h[:4] == b"\0\0\1\xb3"),
)


def _tga_accept(head: bytes) -> bool:
    """TGA's header checks, raising where a format PIL tries first would
    take the head."""
    if tga_header(head) is None:
        return False
    taken = [name for name, accept in _BEFORE_TGA if accept(head)]
    if taken:
        raise ValueError(f"a TGA header that PIL takes for a {taken[0]} file first; not read")
    return True


def _anything(head: bytes) -> bool:
    """The `_accept` of a plugin PIL registers with none: every file."""
    return True


# The formats the port reads, in the order `Image.open` tries them (BMP, DIB,
# GIF, JPEG, PPM and PNG, then the others by name; only where two formats
# could take one head does the order decide): (format, its `_accept` on the
# first 68 bytes, its reader). A reader that raises `GiveWay` (PIL's `_open`
# raising SyntaxError, IndexError, TypeError or struct.error) hands the file
# on to the next format that takes it; IM, IMT, IPTC and SPIDER, which have
# no `_accept`, try every file that reaches them (SPIDER is read by none: it
# gives way, or refuses what PIL opens). `io/ico.py` and `io/icns.py`
# decode PNG frames with this module, so their readers are looked up at the
# call.
_ORDER = (
    ("BMP", lambda h: h[:2] == BMP_MAGIC, read_bmp),
    ("DIB", dib_accept, read_dib),
    ("GIF", lambda h: h[:6] in GIF_MAGICS, read_gif),
    ("JPEG", lambda h: h[:3] == JPEG_MAGIC, read_jpeg),
    ("PNM", is_pnm, read_pnm),
    ("PNG", lambda h: h[:8] == PNG_MAGIC, read_png),
    ("BLP", lambda h: h[:4] in BLP_MAGICS, read_blp),
    ("CUR", lambda h: h[:4] == b"\0\0\2\0", lambda p: ico.read_cur(p)),
    ("PCX", pcx_accept, read_pcx),
    ("DCX", lambda h: h[:4] == DCX_MAGIC, read_dcx),
    ("DDS", lambda h: h[:4] == DDS_MAGIC, read_dds),
    ("FITS", fits_accept, read_fits),
    ("FLI", fli_accept, read_fli),
    ("FTEX", lambda h: h[:4] == FTEX_MAGIC, read_ftex),
    ("GBR", gbr_accept, read_gbr),
    ("ICNS", lambda h: h[:4] == b"icns", lambda p: icns.read_icns(p)),
    ("ICO", lambda h: h[:4] == b"\0\0\1\0", lambda p: ico.read_ico(p)),
    ("IM", _anything, read_im),
    ("IMT", _anything, read_imt),
    ("IPTC", _anything, read_iptc),
    ("MCIDAS", mcidas_accept, read_mcidas),
    ("TIFF", lambda h: h[:4] in TIFF_HEADS, read_tiff),
    ("MSP", lambda h: h[:4] in MSP_MAGICS, read_msp),
    ("PIXAR", lambda h: h[:4] == PIXAR_MAGIC, read_pixar),
    ("PSD", lambda h: h[:4] == PSD_MAGIC, read_psd),
    ("QOI", lambda h: h[:4] == QOI_MAGIC, read_qoi),
    ("SGI", lambda h: h[:2] == SGI_MAGIC, read_sgi),
    ("SPIDER", _anything, read_spider),
    ("SUN", lambda h: h[:4] == SUN_MAGIC, read_sun),
    ("TGA", _tga_accept, read_tga),
    ("WebP", lambda h: h[:4] == b"RIFF" and h[8:12] == b"WEBP", read_webp),
    ("XBM", xbm_accept, read_xbm),
    ("XPM", lambda h: h[:9] == XPM_MAGIC, read_xpm),
    ("XVTHUMB", xvthumb_accept, read_xvthumb),
)
# the formats read (SPIDER is tried, and refused where PIL opens it)
FORMATS = ("JPEG", "PNG", "BMP", "TIFF", "GIF", "WebP", "PNM", "QOI", "SGI", "PCX", "DIB",
           "ICO", "CUR", "DCX", "ICNS", "MSP", "PSD", "SUN", "XBM", "XPM", "FLI", "GBR", "IM",
           "IMT", "IPTC", "PIXAR", "MCIDAS", "XVTHUMB", "FITS", "FTEX", "DDS", "BLP", "TGA")


def read_image(path: str) -> np.ndarray:
    """A dataset image by its first bytes, tried as `Image.open` tries them:
    JPEG, PNG, BMP, DIB (a BMP without its file header), TIFF, GIF, WebP
    (lossy, lossless, with alpha, an animation's first frame), PNM (P1-P6),
    QOI, SGI, PCX, DCX (its first page), ICO and CUR (`io/ico.py`), ICNS
    (`io/icns.py`), MSP (`io/msp.py`), PSD (its merged image, `io/psd.py`),
    SUN (`io/sun.py`), XBM and XPM (`io/xbm.py`, `io/xpm.py`), FLI and FLC
    (the first frame, `io/fli.py`), GBR (`io/gbr.py`), IM (`io/im.py`),
    IMT (`io/imt.py`), IPTC (`io/iptc.py`), PIXAR (`io/pixar.py`), McIdas
    areas of 1- and 2-byte samples (B7: the high byte; `io/mcidas.py`), XV
    thumbnails (B15: RGB332 expanded; `io/xvthumb.py`), FITS of 8 bits and
    unsigned 16 bits, raw or GZIP_1 (B32: by the format's definition;
    `io/fits.py`), FTEX (DXT1 through the port's BC1 decoder, or raw RGB;
    `io/ftex.py`), DDS (RGB masks, L, LA, P (B15), DXT1 / 3 / 5, BC4, BC5,
    BC5S, DX10 BC1-BC5, BC6H (B38: signed endpoints as the definition
    reads them), BC7 and R8G8B8A8 through the port's BCn decoders; B34:
    data short of the image raises; `io/dds.py`), BLP
    (BLP1 JPEG, B35: four components as B, G, R, alpha; BLP1 and BLP2
    palettes; BLP2 DXT1 / 3 / 5 by BLP's own 565 rule, B36 and B37:
    each pixel's own bytes; `io/blp.py`), and TGA, which has no magic, only
    where no format PIL tries first takes the file and TGA's header checks
    pass. IM, IMT, IPTC and SPIDER, which PIL registers with no `_accept`,
    try every file that reaches them (a SPIDER image PIL opens is refused:
    float samples, B21).
    A file PIL gives way on (`io/giveway.py`) goes on to the next format
    that takes its head, as in PIL; a PAM file (`P7`), which no format
    takes, raises naming it -> the reader's array."""
    with open(path, "rb") as f:
        head = f.read(68)
    causes = []
    for name, accept, read in _ORDER:
        try:
            if not accept(head):
                continue
        except ValueError as err:
            raise ValueError(f"{path}: {err}") from None
        try:
            return read(path)
        except GiveWay as err:
            causes.append(f"{name}: {err}")
    if magic_of(head) == b"P7" and not xvthumb_accept(head):
        raise ValueError(f"{path}: {PAM_REFUSED}")
    raise ValueError(f"{path}: not a {', '.join(FORMATS[:-1])} or {FORMATS[-1]}"
                     + (f" ({'; '.join(causes)})" if causes else ""))
