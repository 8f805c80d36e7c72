"""Mac OS icons (ICNS) in numpy and the port's C++, to the arrays PIL 12
gives (the JAX reader opens dataset images with PIL; the machines the port
runs on have none).

`read_icns` walks the blocks as PIL's `IcnsFile` does (a type and a
big-endian length of 8 bytes or more each, up to the header's file size; a
length of 0, or a block header the file cuts, gives way: `io/giveway.py`),
keeps the last block of each type, and decodes the largest (width,
height, scale) of PIL's `SIZES` table that the file holds, merging that
size's blocks in the table's order as `dataforsize` does:

- a PNG sub-image (`ic07`-`ic14`, `icp4`-`icp6`) wins:
  `io/png.py::decode_png`'s array at the PNG's own size, where PIL's size
  setter takes that size (a width that divides the table's width by the
  scale its height divides it by), else refused with PIL's cause;
- else the RGB of `it32` / `ih32` / `il32` / `is32`: three planes in a
  run-length code (`gm_icns_rle` of `csrc/image.cpp`; `_rle_plain` here is
  the same walk in Python, held to it byte for byte and error for error),
  or interleaved RGB where the block holds exactly 3 bytes a pixel;
  `it32` starts with 4 zero bytes. Its mask (`t8mk` / `h8mk` / `l8mk` /
  `s8mk`, a byte a pixel) is the alpha where the file has one (RGBA), else
  the image stays RGB.

JPEG 2000 sub-images are refused with their cause (the port has no JPEG
2000 decoder), as are the forms PIL fails on: another sub-image format, a
mask with no colours, a cut block, a plane whose run-length count ends
other than at its size ("Error reading channel").

`encode_icns` / `write_icns` write PNG sub-images and `it32` / `ih32` /
`il32` / `is32` images, run-length coded or raw, with their masks, for the
tests and `chip_smoke.py`; the training path does not write icons.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from gaussianmesh_tpu_torch.io import png
from gaussianmesh_tpu_torch.io.giveway import GiveWay
from gaussianmesh_tpu_torch.ops import _cuda

ICNS_MAGIC = b"icns"
_JPEG2000 = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")
_JP2_BOX = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
# PIL's `IcnsFile.SIZES`, in its order: (width, height, scale) -> its block
# types and how each is read
SIZES = {
    (512, 512, 2): ((b"ic10", "png"),),
    (512, 512, 1): ((b"ic09", "png"),),
    (256, 256, 2): ((b"ic14", "png"),),
    (256, 256, 1): ((b"ic08", "png"),),
    (128, 128, 2): ((b"ic13", "png"),),
    (128, 128, 1): ((b"ic07", "png"), (b"it32", "rgb"), (b"t8mk", "mask")),
    (64, 64, 1): ((b"icp6", "png"),),
    (32, 32, 2): ((b"ic12", "png"),),
    (48, 48, 1): ((b"ih32", "rgb"), (b"h8mk", "mask")),
    (32, 32, 1): ((b"icp5", "png"), (b"il32", "rgb"), (b"l8mk", "mask")),
    (16, 16, 2): ((b"ic11", "png"),),
    (16, 16, 1): ((b"icp4", "png"), (b"is32", "rgb"), (b"s8mk", "mask")),
}
# the legacy (run-length or raw) images' and masks' types -> their size
LEGACY_SIZES = {code: size for size, fmts in SIZES.items() for code, kind in fmts
                if kind != "png"}


def read_icns(path: str) -> np.ndarray:
    """An ICNS -> uint8 (H, W, 3) RGB, (H, W, 4) RGBA, or a PNG
    sub-image's array."""
    with open(path, "rb") as f:
        return decode_icns(f.read(), path)


def decode_icns(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_icns` of an ICNS file's bytes (`path` names it in errors)."""
    return _decode(data, path, False)


def decode_icns_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_icns` through the plain versions (the run-length walk and the
    PNG rows)."""
    return _decode(data, path, True)


def blocks(data: bytes, path: str = "<bytes>") -> dict:
    """The blocks PIL's `IcnsFile.__init__` finds -> {type: (start of its
    data, its length less its header)}."""
    if len(data) < 8:
        raise GiveWay(f"{path}: ICNS header cut short")
    sig, filesize = struct.unpack_from(">4sI", data)
    if sig != ICNS_MAGIC:
        raise ValueError(f"{path}: not an ICNS")
    found, i = {}, 8
    while i < filesize:
        if len(data) < i + 8:
            raise GiveWay(f"{path}: ICNS block header cut short at byte {i}")
        sig, size = struct.unpack_from(">4sI", data, i)
        if size == 0:
            raise GiveWay(f"{path}: ICNS block {sig!r} of length 0 (PIL: invalid block "
                          "header)")
        found[sig] = (i + 8, size - 8)
        i += size
    return found


def _rle(data: bytes, sizesq: int):
    """Three run-length planes from the start of `data` -> ((3, sizesq)
    uint8, status, the plane that failed, its bytes left) (`gm_icns_rle`;
    status 0, 1 where the data ended inside a run, 11 where a count ended
    other than at 0)."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros((3, sizesq), np.uint8)
    info = np.zeros(3, np.int64)
    status = _cuda.host_library("image").gm_icns_rle(
        src.ctypes.data, len(src), sizesq, out.ctypes.data, info.ctypes.data)
    if status not in (0, 1, 11):
        raise RuntimeError(f"gm_icns_rle returned {status}")
    return out, status, int(info[0]), int(info[1])


def _rle_plain(data: bytes, sizesq: int):
    """`_rle` as a Python loop over the runs (the plain version)."""
    out = np.zeros((3, sizesq), np.uint8)
    i, n = 0, len(data)
    for plane in range(3):
        got, left = bytearray(), sizesq
        while left > 0 and i < n:
            c = data[i]
            i += 1
            if c & 0x80:
                count = c - 125
                if i < n:
                    got += data[i:i + 1] * count
                    i += 1
            else:
                count = c + 1
                got += data[i:i + count]
                i = min(n, i + count)
            left -= count
        if left:
            return out, 11, plane, left
        if len(got) != sizesq:
            return out, 1, plane, left
        out[plane] = np.frombuffer(bytes(got), np.uint8)
    return out, 0, 0, 0


def _sub_png(data, start, path, plain):
    head = data[start:start + 12]
    if head.startswith(png.PNG_MAGIC):
        return (png.decode_png_plain if plain else png.decode_png)(data[start:], path)
    if head.startswith(_JPEG2000) or head == _JP2_BOX:
        raise ValueError(f"{path}: an ICNS JPEG 2000 sub-image; the port has no JPEG 2000 "
                         "decoder")
    raise ValueError(f"{path}: an ICNS sub-image of another format (PIL: Unsupported icon "
                     "subimage format)")


def _sub_rgb(data, code, start, length, side, path, plain):
    if code == b"it32":
        if data[start:start + 4] != bytes(4):
            raise ValueError(f"{path}: it32 without its 4 zero bytes (PIL: Unknown "
                             "signature, expecting 0x00000000)")
        start, length = start + 4, length - 4
    sizesq = side[0] * side[1]
    if length == 3 * sizesq:                    # interleaved RGB, not run-length coded
        raw = data[start:start + length]
        if len(raw) < length:
            raise ValueError(f"{path}: {code.decode()} cut short (PIL: not enough image data)")
        return np.frombuffer(raw, np.uint8).reshape(side[1], side[0], 3)
    planes, status, plane, left = (_rle_plain if plain else _rle)(data[start:], sizesq)
    if status == 11:
        raise ValueError(f"{path}: {code.decode()} plane {plane}: its run-length count ends "
                         f"{left} bytes from its size (PIL: Error reading channel [{left} "
                         "left])")
    if status:
        raise ValueError(f"{path}: {code.decode()} plane {plane}: the data ends inside a run "
                         "(PIL: buffer is not large enough)")
    return np.ascontiguousarray(planes.reshape(3, side[1], side[0]).transpose(1, 2, 0))


def _fits(shape, sizes) -> bool:
    """PIL's `IcnsImageFile` size setter, for a sub-image of `shape`."""
    h, w = shape[:2]
    return w > 0 and h > 0 and any(
        sw * ss // w == sh * ss / h for sw, sh, ss in sizes)


def _decode(data: bytes, path: str, plain: bool) -> np.ndarray:
    found = blocks(data, path)
    sizes = [size for size, fmts in SIZES.items() if any(c in found for c, _ in fmts)]
    if not sizes:
        raise GiveWay(f"{path}: no icon sub-image PIL reads (PIL: No 32bit icon resources "
                      "found)")
    best = max(sizes)
    side = (best[0] * best[2], best[1] * best[2])
    got = {}
    for code, kind in SIZES[best]:              # `dataforsize`, in the table's order
        if code not in found:
            continue
        start, length = found[code]
        if kind == "png":
            got["RGBA"] = _sub_png(data, start, path, plain)
        elif kind == "rgb":
            got["RGB"] = _sub_rgb(data, code, start, length, side, path, plain)
        else:
            raw = data[start:start + side[0] * side[1]]
            if len(raw) < side[0] * side[1]:
                raise ValueError(f"{path}: {code.decode()} mask cut short (PIL: buffer is "
                                 "not large enough)")
            got["A"] = np.frombuffer(raw, np.uint8).reshape(side[1], side[0])
    if "RGBA" in got:
        img = got["RGBA"]
        if not _fits(img.shape, sizes):
            raise ValueError(f"{path}: an ICNS PNG sub-image of {img.shape[1]}x{img.shape[0]}, "
                             "not a size of the file (PIL: This is not one of the allowed "
                             "sizes of this image)")
        return img
    if "RGB" not in got:
        raise ValueError(f"{path}: an ICNS mask with no image (PIL: KeyError 'RGB')")
    if "A" in got:
        return np.concatenate([got["RGB"], got["A"][..., None]], 2)
    return got["RGB"].copy()


# ------------------------------------------------------------------ writer

def encode_icns_rle(plane: np.ndarray) -> bytes:
    """A plane's bytes -> `read_32`'s run-length code: runs of 3 to 130 equal
    bytes as (0x80 + length - 3, byte), the bytes between as literals of up
    to 128 (length - 1, bytes)."""
    x = np.asarray(plane, np.uint8).ravel()
    out, i, n = bytearray(), 0, len(x)
    lit = bytearray()
    while i < n:
        j = i
        while j < n and j - i < 130 and x[j] == x[i]:
            j += 1
        if j - i >= 3:
            for k in range(0, len(lit), 128):
                out += bytes([len(lit[k:k + 128]) - 1]) + lit[k:k + 128]
            lit = bytearray()
            out += bytes([0x80 + j - i - 3, int(x[i])])
            i = j
        else:
            lit.append(int(x[i]))
            i += 1
    for k in range(0, len(lit), 128):
        out += bytes([len(lit[k:k + 128]) - 1]) + lit[k:k + 128]
    return bytes(out)


def encode_icns(images: dict, rle: bool = True) -> bytes:
    """{block type: uint8 image} -> the bytes of an ICNS, blocks in the
    order given: a PNG type (`ic07`...) takes any image `encode_png` takes;
    `it32` / `ih32` / `il32` / `is32` an (H, W, 3) RGB of their size, run-
    length coded (`rle`) or raw; `t8mk` / `h8mk` / `l8mk` / `s8mk` an (H, W)
    mask of their size."""
    body = b""
    for code, img in images.items():
        img = np.asarray(img, np.uint8)
        if code in LEGACY_SIZES and code.endswith(b"mk"):
            payload = img.tobytes()
        elif code in LEGACY_SIZES:
            payload = (b"".join(encode_icns_rle(img[..., c]) for c in range(3)) if rle
                       else img.tobytes())
            payload = (bytes(4) if code == b"it32" else b"") + payload
        else:
            payload = png.encode_png(img)
        body += code + struct.pack(">I", 8 + len(payload)) + payload
    return ICNS_MAGIC + struct.pack(">I", 8 + len(body)) + body


def write_icns(path: str, images: dict, **kwargs) -> None:
    """`encode_icns(images, **kwargs)` written to `path` (its directory made
    if needed)."""
    data = encode_icns(images, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
