"""DirectDraw Surface textures (`.dds`) in numpy and the port's BCn
decoders, to the arrays PIL 12 gives (the JAX reader opens dataset images
with PIL; the machines the port runs on have none).

`read_dds` reads what PIL's `DdsImagePlugin` opens, all little-endian:
`DDS `, a header of 124 bytes, its pixel format's flags, FourCC, bit count
and masks, and after a `DX10` FourCC 20 bytes more, the first its DXGI
format. PIL's branches, in its order:

- RGB flag: 3 masks, 4 with the alpha flag (RGBA), one pixel every
  `bitcount // 8` bytes from byte 128, each channel `int((v & mask) >>
  shift) / (mask >> shift) * 255)` as `DdsRgbDecoder` computes it (a 5-bit
  16 reads 131; a mask of 0 gives 0);
- luminance flag: L at 8 bits, LA at 16 with the alpha flag (read as PIL's
  `convert("RGBA")`, fault A2's rule), any other bit count refused;
- palette flag: 1,024 bytes of palette, then the indices, expanded through
  the palette's RGB as PIL's `convert("RGB")` (PIL opens mode P, whose
  indices the JAX reader trains: fault B15's rule);
- FourCC: `DXT1`, `DXT3`, `DXT5` (BC1-BC3 to RGBA), `BC4U` and `ATI1` (BC4
  to L), `BC5U` and `ATI2` (BC5 to RGB), `BC5S` (BC5 signed), through
  `io/bcn.py` (`gm_bcn_decode`); `DX10` with the DXGI
  formats BC1-BC5 (typeless and unorm; BC5 snorm) and BC7 (typeless, unorm
  and sRGB) the same way, and R8G8B8A8 (typeless, unorm and sRGB) raw;
  DX10 BC6H (DXGI 95 unsigned, 96 signed half floats) to RGB, brought
  down to 8 bits by PIL's rule (`io/bcn.py`; the signed form read by the
  definition where PIL is not: fault B38). BC6H typeless (94), which PIL
  does not implement, fails as PIL's `_open` does.

An alpha becomes the training mask. The data is read from where PIL's
`_open` leaves the file (byte 128, 148 after a DX10 header, or past the
palette), since `load_seek` does nothing. A file shorter than its header
gives way (`io/giveway.py`), as does a width or height of 0 and a DX10
header cut short, as in PIL; another header size, a header cut inside
its 124 bytes and a format PIL does not implement make PIL's `_open` fail,
and `read_dds` raises. Data shorter than the image needs raises ("image
file is truncated"); where PIL's `DdsRgbDecoder` reads zeros past the end
of the file instead (fault B34: the JAX reader trains them), it raises
naming the bytes found and needed.

`encode_dds` / `write_dds` write DXT1, DXT5, BC4, BC5, DX10 BC7, DX10
BC6H (unsigned and signed) and 16-bit 565 textures (`io/bcn.py`'s
writers), and `dds_head` any header, for the tests and `chip_smoke.py`;
the training path does not write textures.
"""

from __future__ import annotations

import functools
import os
import struct

import numpy as np

from gaussianmesh_tpu_torch.io import bcn
from gaussianmesh_tpu_torch.io.giveway import GiveWay

DDS_MAGIC = b"DDS "
# the pixel format's flags PIL reads
ALPHAPIXELS, FOURCC, PALETTEINDEXED8, RGB, LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000
# FourCC -> (BCn kind, signed)
FOURCCS = {b"DXT1": (bcn.BC1, False), b"DXT3": (bcn.BC2, False), b"DXT5": (bcn.BC3, False),
           b"BC4U": (bcn.BC4, False), b"ATI1": (bcn.BC4, False), b"BC5S": (bcn.BC5, True),
           b"BC5U": (bcn.BC5, False), b"ATI2": (bcn.BC5, False)}
# DX10's DXGI formats PIL reads -> (BCn kind, signed), or "raw" (R8G8B8A8)
DXGI = {70: (bcn.BC1, False), 71: (bcn.BC1, False), 73: (bcn.BC2, False),
        74: (bcn.BC2, False), 76: (bcn.BC3, False), 77: (bcn.BC3, False),
        79: (bcn.BC4, False), 80: (bcn.BC4, False), 82: (bcn.BC5, False),
        83: (bcn.BC5, False), 84: (bcn.BC5, True), 97: (bcn.BC7, False),
        98: (bcn.BC7, False), 99: (bcn.BC7, False), 95: (bcn.BC6H, False),
        96: (bcn.BC6H, True), 27: "raw", 28: "raw", 29: "raw"}
HEAD = 128


def read_dds(path: str) -> np.ndarray:
    """A DDS texture -> uint8 (H, W) L, (H, W, 3) RGB or (H, W, 4) RGBA."""
    with open(path, "rb") as f:
        return decode_dds(f.read(), path)


def header(data: bytes, path: str = "<bytes>") -> tuple:
    """PIL's `DdsImageFile._open` on a texture's bytes -> (width, height,
    form, where the data starts, the form's arguments); form is "masks"
    (bit count, masks), "L", "LA", "P" (the palette's bytes), "bcn" (kind,
    signed: BC6H too) or "raw" (RGBA). Gives way or raises where `_open`
    does."""
    if not data.startswith(DDS_MAGIC):
        raise GiveWay(f"{path}: not a DDS file")
    if len(data) < 8:
        raise GiveWay(f"{path}: DDS header cut short")
    (size,) = struct.unpack_from("<I", data, 4)
    if size != 124:
        raise ValueError(f"{path}: Unsupported header size {size} (PIL's DDS reader needs 124)")
    if len(data) < HEAD:
        raise ValueError(f"{path}: Incomplete DDS header: {len(data) - 8} bytes")
    _flags, height, width = struct.unpack_from("<3I", data, 8)
    pfflags, fourcc, bitcount = struct.unpack_from("<I4sI", data, 80)
    where, args = HEAD, ()
    if pfflags & RGB:
        form, args = "masks", (bitcount, struct.unpack_from(
            "<4I" if pfflags & ALPHAPIXELS else "<3I", data, 92))
    elif pfflags & LUMINANCE:
        if bitcount == 8:
            form = "L"
        elif bitcount == 16 and pfflags & ALPHAPIXELS:
            form = "LA"
        else:
            raise ValueError(f"{path}: Unsupported bitcount {bitcount} for {pfflags} (DDS "
                             "luminance)")
    elif pfflags & PALETTEINDEXED8:
        form, where, args = "P", HEAD + 1024, (data[HEAD:HEAD + 1024],)
    elif pfflags & FOURCC:
        form = "bcn"
        if fourcc in FOURCCS:
            args = FOURCCS[fourcc]
        elif fourcc == b"DX10":
            if len(data) < HEAD + 4:
                raise GiveWay(f"{path}: DDS DX10 header cut short")
            (dxgi,) = struct.unpack_from("<I", data, HEAD)
            where = HEAD + 20
            if dxgi not in DXGI:
                raise ValueError(f"{path}: Unimplemented DXGI format {dxgi} (DDS)")
            if DXGI[dxgi] == "raw":
                form = "raw"
            else:
                args = DXGI[dxgi]
        else:
            raise ValueError(f"{path}: Unimplemented DDS pixel format "
                             f"{int.from_bytes(fourcc, 'little')} ({fourcc!r})")
    else:
        raise ValueError(f"{path}: Unknown DDS pixel format flags {pfflags}")
    if width == 0 or height == 0:
        raise GiveWay(f"{path}: a DDS texture of {width}x{height} pixels")
    return width, height, form, where, args


def decode_dds(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_dds` of a texture's bytes (`path` names it in errors)."""
    return _decode(data, path, bcn.decode)


def decode_dds_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_dds` with the blocks decoded in numpy (`bcn.decode_plain`)."""
    return _decode(data, path, bcn.decode_plain)


def _need(body: bytes, need: int, path: str) -> bytes:
    if len(body) < need:
        raise ValueError(f"{path}: DDS data holds {len(body)} of {need} bytes (PIL: image "
                         "file is truncated)")
    return body[:need]


def _masks(body: bytes, w: int, h: int, bitcount: int, masks, path: str) -> np.ndarray:
    """`DdsRgbDecoder`'s channels; the data must hold every pixel (B34)."""
    step = bitcount // 8
    need = w * h * step
    if len(body) < need:
        raise ValueError(f"{path}: DDS data holds {len(body)} of the {need} bytes its "
                         f"{w}x{h} pixels of {bitcount} bits need; PIL reads zeros past the "
                         "end of the file (fault B34)")
    raw = np.frombuffer(body, np.uint8, need).reshape(w * h, step)
    v = np.zeros(w * h, np.int64)
    for k in range(min(step, 4)):               # the masks hold 32 bits
        v |= raw[:, k].astype(np.int64) << (8 * k)
    out = np.zeros((w * h, len(masks)), np.uint8)
    for c, mask in enumerate(masks):
        if mask:
            shift = (mask & -mask).bit_length() - 1
            out[:, c] = np.floor(((v & mask) >> shift) / (mask >> shift) * 255)
    return out.reshape(h, w, len(masks))


def _decode(data: bytes, path: str, bcn_decode) -> np.ndarray:
    w, h, form, where, args = header(data, path)
    body = data[where:]
    if form == "masks":
        return _masks(body, w, h, *args, path)
    if form == "L":
        return np.frombuffer(_need(body, w * h, path), np.uint8).reshape(h, w).copy()
    if form == "LA":
        la = np.frombuffer(_need(body, 2 * w * h, path), np.uint8).reshape(h, w, 2)
        return np.ascontiguousarray(la[..., [0, 0, 0, 1]])
    if form == "P":
        idx = np.frombuffer(_need(body, w * h, path), np.uint8).reshape(h, w)
        pal = np.frombuffer(args[0].ljust(1024, b"\0"), np.uint8).reshape(256, 4)
        return np.ascontiguousarray(pal[idx, :3])
    if form == "raw":
        return np.frombuffer(_need(body, 4 * w * h, path), np.uint8).reshape(h, w, 4).copy()
    kind, signed = args
    return bcn_decode(kind, body, w, h, path, signed=signed)


# ------------------------------------------------------------------ writers

def dds_head(width: int, height: int, pfflags: int, fourcc: bytes = b"\0\0\0\0",
             bitcount: int = 0, masks=(0, 0, 0, 0), dxgi: int | None = None) -> bytes:
    """A DDS header (and DX10's, where `dxgi` is given) of these fields."""
    head = (DDS_MAGIC + struct.pack("<7I", 124, 0x1007, height, width, 0, 0, 0) + bytes(44)
            + struct.pack("<2I", 32, pfflags) + fourcc + struct.pack("<I", bitcount)
            + struct.pack("<4I", *masks) + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head


FORMS = ("DXT1", "DXT5", "BC4", "BC5", "BC7", "BC6H", "BC6HS", "RGB565")


def encode_dds(img: np.ndarray, form: str) -> tuple[bytes, np.ndarray]:
    """An image -> (the bytes of a DDS texture of `form`, what it decodes
    to): DXT1 and BC5 of (H, W, 3) RGB, DXT5 and DX10 BC7 of (H, W, 4) RGBA,
    BC4 (`BC4U`) of (H, W) gray, DX10 BC6H (DXGI 95) and BC6HS (96, signed)
    of RGB, RGB565 (16-bit masks) of RGB."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    if form == "RGB565":
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError("RGB565 takes (H, W, 3) RGB images")
        c = img.astype(np.uint32)
        v = ((c[..., 0] * 31 + 127) // 255) << 11 | ((c[..., 1] * 63 + 127) // 255) << 5 \
            | (c[..., 2] * 31 + 127) // 255
        masks = (0xF800, 0x07E0, 0x001F, 0)
        body = v.astype("<u2").tobytes()
        return (dds_head(w, h, RGB, bitcount=16, masks=masks) + body,
                _masks(body, w, h, 16, masks[:3], "<bytes>"))
    encode, fourcc, dxgi = {"DXT1": (bcn.encode_bc1, b"DXT1", None),
                            "DXT5": (bcn.encode_bc3, b"DXT5", None),
                            "BC4": (bcn.encode_bc4, b"BC4U", None),
                            "BC5": (bcn.encode_bc5, b"BC5U", None),
                            "BC7": (bcn.encode_bc7, b"DX10", 98),
                            "BC6H": (bcn.encode_bc6h, b"DX10", 95),
                            "BC6HS": (functools.partial(bcn.encode_bc6h, signed=True),
                                      b"DX10", 96)}.get(form, (None,) * 3)
    if encode is None:
        raise ValueError(f"encode_dds writes {', '.join(FORMS)}, not {form!r}")
    body, want = encode(img)
    return dds_head(w, h, FOURCC, fourcc, dxgi=dxgi) + body, want


def write_dds(path: str, img: np.ndarray, form: str) -> np.ndarray:
    """`encode_dds(img, form)` written to `path` (its directory made if
    needed) -> what the texture decodes to."""
    data, want = encode_dds(img, form)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return want
