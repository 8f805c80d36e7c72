"""IFUNC Image Memory (IM) files in numpy, to the arrays PIL 12 gives (the
JAX reader opens dataset images with PIL; the machines the port runs on
have none).

`read_im` reads what PIL's `ImImagePlugin` opens. PIL registers IM with no
`_accept`, so it tries IM's `_open` on every file that reaches it, and so
does `io/png.py::read_image`; `open_im` follows that `_open` step by step
on the file: a line feed in the first 100 bytes, then header lines of at
most 100 bytes (`Key: value`, PIL's `split` pattern; a line that does not
match gives way) up to a NUL, a 0x1A or the end, at least one of PIL's
tags, the data after the next 0x1A, and a 768-byte `Lut` after it where
the header names one. The size defaults to 512 x 512 and the type to L.

The first frame's rows are stored bottom-up (PIL's raw tile of step -1),
in these types (PIL's modes and raw modes):
- `0 1`, `L 1`, `B1` -> 1-bit rows, a set bit white; PIL opens mode 1,
  whose `np.asarray` is a bool array the JAX reader divides by 255 (fault
  B16): `read_im` gives `convert("L")`'s 0 and 255;
- `Greyscale` / `Grayscale` (L), `L 8` / `L*8` (mode F of the byte values,
  which the JAX reader reads right) -> (H, W);
- `B2`, `B4` (2- and 4-bit indices) and a gray type with a colour `Lut`
  (8-bit indices; a colour `Lut` makes `B2` / `B4` 8-bit too, as PIL's
  `_open` sets the raw mode P) open as mode P, whose `np.asarray` is the
  indices (fault B15): `read_im` expands them as `convert("RGB")` does,
  through the `Lut` (its 256 reds, then greens, then blues), or through
  PIL's empty palette (black) where there is none;
- `LA` -> (H, W, 4), gray repeated (fault A2's rule: `convert("RGBA")`);
  `LA` or `PA` with a colour `Lut` -> the palette's RGB and the alpha;
  `PA` without one PIL cannot load ("unknown raw mode");
- `RGB` and `RGBX` (each row's planes in turn), `X 24` (interleaved) ->
  RGB; `RGBA` -> RGBA; `RGB3` / `RYB3` (three planes, PIL puts the first in
  G and the second in R; open item C5 of ROADMAP.md) -> RGB;
- `CMYK` opens as 4 channels, which the JAX reader trains with K as the
  mask (fault B14): `read_im` gives `convert("RGB")`;
- `YCC` opens as YCbCr, which the JAX reader trains as R, G, B (fault
  B30): `read_im` gives `convert("RGB")` (PIL's fixed-point tables,
  `_YCC`);
- `L 16`, `L 16L`, `L 16B` open as I;16, which the JAX reader divides
  into values up to 257 (fault B7): `read_im` gives the high byte.

A gray `Lut` that is not linear is kept by PIL as `im.lut` and never
applied (open item C4), and `read_im` reads the samples as PIL does; an
`RGB` file's `Lut` alike. The float and signed types (`L 32F`, `L 8S`,
`L 16S`, `L 32`, `L 32S`, `L*n`) open as mode F or I, which the JAX reader
divides by 255 (fault B21): `read_im` refuses them with that cause, as it
refuses every type PIL cannot load (`RLB`, `RYB`, a type PIL does not
know). `_open` giving way gives way (`io/giveway.py`); where PIL's `_open`
raises another error (a size or scale that is not a number), `Image.open`
itself fails, and `read_im` raises.

`encode_im` / `write_im` write these types, for the tests and
`chip_smoke.py`; the training path does not write IM files.
"""

from __future__ import annotations

import io
import os
import re

import numpy as np

from gaussianmesh_tpu_torch.io.giveway import GiveWay
from gaussianmesh_tpu_torch.io.jpeg import cmyk_to_rgb

COMMENT, FRAMES, LUT, SCALE, SIZE, MODE = ("Comment", "File size (no of images)", "Lut",
                                           "Scale (x,y)", "Image size (x*y)", "Image type")
TAGS = (COMMENT, "Date", "Digitalization equipment", FRAMES, LUT, "Name", SCALE, SIZE, MODE)

# ImImagePlugin.OPEN: the "Image type" values PIL knows -> (mode, raw mode)
OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
    "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"), "B2 image": ("P", "P;2"),
    "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
    "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
    "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")

_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")

# (mode, raw mode) `read_im` reads -> (bytes a row per pixel, or the
# fraction for packed bits; planes a row, line-interleaved)
_ROWS = {("1", "1"): (1, 8), ("L", "L"): (1, 1), ("P", "P"): (1, 1), ("P", "L"): (1, 1),
         ("P", "P;2"): (1, 4), ("P", "P;4"): (1, 2), ("F", "F;8"): (1, 1),
         ("LA", "LA;L"): (2, 1), ("PA", "PA;L"): (2, 1), ("RGB", "RGB;L"): (3, 1),
         ("RGB", "RGB"): (3, 1), ("RGB", "RGBX;L"): (4, 1), ("RGBA", "RGBA;L"): (4, 1),
         ("CMYK", "CMYK;L"): (4, 1), ("YCbCr", "YCbCr;L"): (3, 1),
         ("I;16", "I;16"): (2, 1), ("I;16L", "I;16L"): (2, 1), ("I;16B", "I;16B"): (2, 1)}


def _number(s: str):
    """ImImagePlugin.number: an int, else a float (ValueError else)."""
    try:
        return int(s)
    except ValueError:
        return float(s)


def _ycc_tables():
    """PIL's YCbCr -> RGB tables (`ConvertYCbCr.c`: (int)(k * 64 * (i - 128)
    + 0.5), 6 fraction bits) -> R_Cr, G_Cb, G_Cr, B_Cb as int64."""
    i = np.arange(256) - 128.0
    return [np.trunc(k * 64 * i + 0.5).astype(np.int64)
            for k in (1.40200, -0.34414, -0.71414, 1.77200)]


_YCC = _ycc_tables()


def ycc_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 YCbCr -> RGB as PIL's `convert("RGB")` gives it."""
    y, cb, cr = (ycc[..., k].astype(np.int64) for k in range(3))
    r_cr, g_cb, g_cr, b_cb = _YCC
    rgb = np.stack([y + (r_cr[cr] >> 6), y + ((g_cb[cb] + g_cr[cr]) >> 6),
                    y + (b_cb[cb] >> 6)], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def open_im(fp, path: str = "<bytes>") -> dict:
    """PIL's `ImImageFile._open` on the file object `fp` (at its start) ->
    {mode, rawmode, size, lut (768 bytes or None), offset}; gives way where
    `_open` does; raises ValueError where it raises ValueError (a size,
    scale or frame count that is not a number: `Image.open` fails)."""
    if b"\n" not in fp.read(100):
        raise GiveWay(f"{path}: not an IM file")
    fp.seek(0)
    n = 0
    info = {MODE: "L", SIZE: (512, 512), FRAMES: 1}
    rawmode = "L"
    while True:
        s = fp.read(1)
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        s = s + fp.readline(100)         # past 100 bytes the line gives way
        if len(s) > 100:
            raise GiveWay(f"{path}: not an IM file")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _SPLIT.match(s)
        if not m:
            raise GiveWay(f"{path}: Syntax error in IM header: "
                          f"{s.decode('ascii', 'replace')}")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in (FRAMES, SCALE, SIZE):
            try:
                v = tuple(map(_number, v.replace("*", ",").split(",")))
            except ValueError as err:
                raise ValueError(f"{path}: an IM header's {k!r} is not a number, which PIL "
                                 f"cannot open ({err})") from None
            if len(v) == 1:
                v = v[0]
        elif k == MODE and v in OPEN:
            v, rawmode = OPEN[v]
        if k == COMMENT:
            info.setdefault(k, []).append(v)
        else:
            info[k] = v
        if k in TAGS:
            n += 1
    if not n:
        raise GiveWay(f"{path}: Not an IM file")
    size, mode = info[SIZE], info[MODE]
    while s and not s.startswith(b"\x1a"):
        s = fp.read(1)
    if not s:
        raise GiveWay(f"{path}: IM File truncated")
    lut = None
    if LUT in info:
        lut = fp.read(768)
        grey = True
        for i in range(256):              # PIL's test, IndexError (giving way) and all
            try:
                if lut[i] == lut[i + 256]:
                    same = lut[i + 512] == lut[i]
                    grey = grey and same
                else:
                    grey = False
            except IndexError:
                raise GiveWay(f"{path}: IM Lut cut short") from None
        if mode in ("L", "LA", "P", "PA") and not grey:
            if mode in ("L", "P"):
                mode = rawmode = "P"
            else:
                mode, rawmode = "PA", "PA;L"
        else:
            lut = None                    # kept by PIL as `im.lut`, never applied
    offset = fp.tell()
    try:
        if rawmode in ("RGB;T", "RYB;T"):
            size[0] * size[1]             # PIL's `_open` computes the plane size here
        ok = bool(mode) and size[0] > 0 and size[1] > 0
    except TypeError:
        ok = False                        # a size of one number (TypeError: gives way)
    if not ok:
        raise GiveWay(f"{path}: an IM file of mode {mode!r} and size {size} (PIL: not "
                      "identified by this driver)")
    return dict(mode=mode, rawmode=rawmode, size=size, lut=lut, offset=offset)


def read_im(path: str) -> np.ndarray:
    """An IM file -> uint8 (H, W), (H, W, 3) or (H, W, 4)."""
    with open(path, "rb") as f:
        head = open_im(f, path)
        return _load(head, f.read(), path)


def decode_im(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_im` of an IM file's bytes (`path` names it in errors)."""
    fp = io.BytesIO(data)
    head = open_im(fp, path)
    return _load(head, fp.read(), path)


def _load(head: dict, body: bytes, path: str) -> np.ndarray:
    """The first frame after the header (`body`) -> the array `read_im` gives."""
    mode, rawmode, size, lut = head["mode"], head["rawmode"], head["size"], head["lut"]
    if len(size) != 2 or not all(isinstance(x, int) for x in size):
        raise ValueError(f"{path}: an IM size of {size}, which PIL cannot load")
    w, h = size
    if mode in ("F", "I") and rawmode != "F;8":
        raise ValueError(f"{path}: an IM file of raw mode {rawmode} opens as mode {mode}, "
                         "whose samples the JAX reader divides by 255 (fault B21); not read")
    if rawmode in ("RGB;T", "RYB;T") and mode == "RGB":
        need = 3 * w * h
        if len(body) < need:
            raise ValueError(f"{path}: IM planes end after {len(body)} of {need} bytes "
                             "(PIL: image file is truncated)")
        planes = np.frombuffer(body, np.uint8, need).reshape(3, h, w)[:, ::-1]
        return np.ascontiguousarray(planes[[1, 0, 2]].transpose(1, 2, 0))
    if (mode, rawmode) not in _ROWS:
        raise ValueError(f"{path}: an IM file of mode {mode!r} and raw mode {rawmode!r}, "
                         "which PIL cannot load (unknown raw mode or unrecognized image "
                         "mode)")
    per, pack = _ROWS[mode, rawmode]
    stride = -(-w // pack) if pack > 1 else per * w
    need = stride * h
    if len(body) < need:
        raise ValueError(f"{path}: IM data ends after {len(body)} of {need} bytes (PIL: "
                         "image file is truncated)")
    rows = np.frombuffer(body, np.uint8, need).reshape(h, stride)[::-1]
    if pack == 8:                         # 1 bit a pixel, set white (B16)
        return np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
    if pack > 1:                          # 2 or 4 bits a pixel, the first the highest
        bits = 8 // pack
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        px = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(h, -1)[:, :w]
    elif per == 1:
        px = rows
    elif rawmode in ("RGB", "I;16", "I;16L", "I;16B"):
        px = rows.reshape(h, w, per)
    else:                                 # each row's planes in turn
        px = rows.reshape(h, per, w).transpose(0, 2, 1)
    if mode in ("P", "PA"):
        pal = (np.zeros((256, 3), np.uint8) if lut is None
               else np.frombuffer(lut, np.uint8).reshape(3, 256).T)
        if mode == "P":
            return np.ascontiguousarray(pal[px])
        return np.concatenate([pal[px[..., 0]], px[..., 1:]], 2)
    if mode == "LA":                      # A2: PIL's convert("RGBA")
        return np.ascontiguousarray(px[..., [0, 0, 0, 1]])
    if rawmode == "RGBX;L":
        return np.ascontiguousarray(px[..., :3])
    if mode == "CMYK":                    # B14
        return cmyk_to_rgb(np.ascontiguousarray(px))
    if mode == "YCbCr":                   # B30
        return ycc_to_rgb(px)
    if mode.startswith("I;16"):           # B7: the high byte
        return np.ascontiguousarray(px[..., 0 if mode == "I;16B" else 1])
    return np.ascontiguousarray(px)


# ------------------------------------------------------------------ writer

# the writer's types: (what it takes) -> the "Image type" value
_TYPES = {"1": "0 1", "L": "Greyscale", "LA": "LA", "RGB": "RGB", "RGBA": "RGBA",
          "RGBX": "RGBX", "CMYK": "CMYK", "YCbCr": "YCC", "I;16": "L 16", "I;16B": "L 16B",
          "P": "Greyscale", "B2": "B2", "B4": "B4", "RGB3": "RGB3", "X24": "X 24", "L8": "L 8"}


def encode_im(img: np.ndarray, mode: str, lut: np.ndarray | None = None) -> bytes:
    """An image -> the bytes of an IM file of one frame, rows bottom-up,
    as PIL's writer lays them out (a 512-byte header ending in 0x1A, the
    `Lut` after it). `mode`: "1" ((H, W), nonzero white), "L", "B2", "B4"
    (indices under 4 / 16), "P" ((H, W) indices; `lut` (256, 3)), "LA",
    "RGB", "X24", "RGB3" (the planes PIL reads as R, G, B), "RGBA", "RGBX",
    "CMYK", "YCbCr" ((H, W, C) samples), "I;16" / "I;16B" ((H, W) uint16)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    head = f"Image type: {_TYPES[mode]} image\r\nName: image\r\n"
    head += f"Image size (x*y): {w}*{h}\r\nFile size (no of images): 1\r\n"
    if lut is not None:
        head += "Lut: 1\r\n"
    data = head.encode("ascii")
    data += b"\0" * (511 - len(data)) + b"\x1a"
    if lut is not None:
        data += np.asarray(lut, np.uint8).T.tobytes()
    rows = img[::-1]
    if mode == "1":
        body = np.packbits(rows != 0, axis=1)
    elif mode in ("B2", "B4") and lut is None:   # a colour `Lut` makes PIL read bytes
        per = 4 if mode == "B2" else 2
        bits = 8 // per
        pad = np.zeros((h, -(-w // per) * per), np.uint8)
        pad[:, :w] = rows
        groups = pad.reshape(h, -1, per).astype(np.uint8)
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        body = np.bitwise_or.reduce(groups << shifts, axis=2).astype(np.uint8)
    elif mode in ("I;16", "I;16B"):
        body = rows.astype("<u2" if mode == "I;16" else ">u2")
    elif mode == "RGB3":
        body = rows.transpose(2, 0, 1)[[1, 0, 2]]
    elif mode in ("L", "L8", "P", "X24", "B2", "B4"):
        body = rows.astype(np.uint8)
    else:                                 # each row's planes in turn
        body = rows.astype(np.uint8).transpose(0, 2, 1)
    return data + np.ascontiguousarray(body).tobytes()


def write_im(path: str, img: np.ndarray, mode: str, **kwargs) -> None:
    """`encode_im(img, mode, **kwargs)` written to `path` (its directory
    made if needed)."""
    data = encode_im(img, mode, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
