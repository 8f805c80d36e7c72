"""Photoshop (PSD) images in numpy and the port's C++, to the arrays PIL 12
gives where PIL reads them right (the JAX reader opens dataset images with
PIL; the machines the port runs on have none).

`read_psd` reads what `Image.open` gives of a PSD: the merged image (the
composite after the layer section; layers are not read). The header is
PIL's `PsdImagePlugin._open`'s: "8BPS", version 1, channels, height,
width, depth and colour mode; the colour-mode, resource and layer sections
are walked and skipped as PIL walks them (a header or section the file
cuts, another version (2, PSB) and a depth or mode PIL does not read give
way, `io/giveway.py`). Then the composite: compression 0 (raw planes) or 1
(PackBits: a 2-byte count for each row of every channel, then the rows,
each decoded to exactly its row by `gm_packbits_decode` of
`csrc/image.cpp`, one call a row, or by `io/tiff.py::packbits_decode_plain`;
a row that gives more or fewer bytes raises). Modes, 8 bits a sample:

- 0 (bitmap, 1 bit) -> (H, W) 0 and 255. Adobe's format, and the readers
  that follow it, take a set bit as black; PIL's raw mode 1 takes it as
  white, so the JAX reader trains every bitmap PSD inverted (fault B28),
  besides B16's 0 and 0.0039. `read_psd` gives a set bit 0.
- 0 at 8 bits, 1 (gray), 7 (multichannel) and 8 (duotone) -> (H, W), the
  first channel;
- 2 (indexed) -> RGB through the 768-byte colour table (256 reds, greens,
  blues), which PIL opens as mode P (fault B15: `convert("RGB")`); a
  colour-mode section of another size raises (PIL keeps no palette, and
  its `convert` gives black);
- 3 (RGB) -> RGB, or RGBA where the file has exactly 4 channels (PIL's
  rule; a fifth channel drops the alpha as well);
- 4 (CMYK, stored inverted) -> RGB by `io/jpeg.py::cmyk_to_rgb`, PIL's
  `convert("RGB")`: PIL opens it as CMYK, whose fourth channel the JAX
  reader takes for an alpha mask (fault B14, as for CMYK JPEGs and TIFFs);
- 9 (Lab) raises: PIL opens it as mode LAB, which the JAX reader trains as
  R, G, B (fault B26). A ZIP-compressed composite (2 or 3) raises, as PIL
  cannot load it.

PIL reads the PackBits counts of only the channels its mode keeps, and
starts the rows after them: where the file has more channels (gray or
indexed with an alpha, RGB or CMYK with a spot or mask channel), it decodes
part of the count table as pixels (fault B27). `read_psd` skips the counts
of every channel, as the format defines them.

`encode_psd` / `write_psd` write every mode `read_psd` reads, raw or
PackBits, for the tests and `chip_smoke.py`; the training path does not
write PSD.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from gaussianmesh_tpu_torch.io import tiff
from gaussianmesh_tpu_torch.io.giveway import GiveWay
from gaussianmesh_tpu_torch.io.jpeg import cmyk_to_rgb
from gaussianmesh_tpu_torch.ops import _cuda

PSD_MAGIC = b"8BPS"
# (colour mode, bits) -> (PIL's mode, channels it keeps); PIL's `MODES`
MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
         (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
         (9, 8): ("LAB", 3)}
_OVERFLOW = 8                          # csrc/image.cpp's kOverflow
_NAMES = {0: "bitmap", 1: "gray", 2: "indexed", 3: "RGB", 4: "CMYK", 7: "multichannel",
          8: "duotone", 9: "Lab"}


def read_psd(path: str) -> np.ndarray:
    """A PSD -> uint8 (H, W), (H, W, 3) or (H, W, 4)."""
    with open(path, "rb") as f:
        return decode_psd(f.read(), path)


def decode_psd(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_psd` of a PSD's bytes (`path` names it in errors)."""
    return _decode(data, path, _rows)


def decode_psd_plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`decode_psd` with PackBits rows decoded by the plain version."""
    return _decode(data, path, _rows_plain)


def _rows(data: bytes, at: list, counts: list, row: int):
    """PackBits rows (row k: data[at[k]:at[k] + counts[k]]) -> ((rows, row)
    uint8, None), or (None, (k, the bytes row k gives, or -1 where it
    decodes past `row`)): one `gm_packbits_decode` call a row, straight
    into the planes."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty((len(counts), row), np.uint8)
    n_out = np.zeros(1, np.int64)
    decode = _cuda.host_library("image").gm_packbits_decode
    base, dest = src.ctypes.data, out.ctypes.data
    for k, (a, n) in enumerate(zip(at, counts)):
        status = decode(base + a, n, dest + k * row, row, n_out.ctypes.data)
        if status not in (0, _OVERFLOW):
            raise RuntimeError(f"gm_packbits_decode returned {status}")
        if status or n_out[0] != row:
            return None, (k, -1 if status else int(n_out[0]))
    return out, None


def _rows_plain(data: bytes, at: list, counts: list, row: int):
    """`_rows` by `io/tiff.py::packbits_decode_plain` (the plain version)."""
    out = np.empty((len(counts), row), np.uint8)
    for k, (a, n) in enumerate(zip(at, counts)):
        try:
            got = tiff.packbits_decode_plain(data[a:a + n], row)
        except ValueError:
            return None, (k, -1)
        if len(got) != row:
            return None, (k, len(got))
        out[k] = got
    return out, None


class _File:
    """Reads and seeks over bytes as PIL does over a file: a read past the
    end is short, a seek past it allowed; a number a read cuts gives way
    (PIL's struct.error)."""

    def __init__(self, data: bytes, path: str):
        self.data, self.path, self.pos = data, path, 0

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + max(n, 0)]
        self.pos += len(out)
        return out

    def number(self, size: int, what: str) -> int:
        b = self.read(size)
        if len(b) < size:
            raise GiveWay(f"{self.path}: PSD {what} cut short")
        return int.from_bytes(b, "big")


def header(data: bytes, path: str = "<bytes>"):
    """A PSD's header and sections as PIL's `_open` walks them -> (width,
    height, colour mode, depth, channels in the file, the colour-mode
    data, where the composite's compression is)."""
    f = _File(data, path)
    head = f.read(26)
    if len(head) < 26 or not head.startswith(PSD_MAGIC):
        raise GiveWay(f"{path}: PSD header cut short")
    version, channels, h, w, bits, mode = struct.unpack_from(">H6xHIIHH", head, 4)
    if version != 1:
        raise GiveWay(f"{path}: PSD version {version}" + (" (PSB)" if version == 2 else "")
                      + ", which PIL does not read (not a PSD file)")
    if (mode, bits) not in MODES:
        raise GiveWay(f"{path}: a {bits}-bit PSD of colour mode {mode} "
                      f"({_NAMES.get(mode, 'unknown')}), which PIL does not read")
    if MODES[mode, bits][1] > channels:
        raise ValueError(f"{path}: a PSD of {channels} channels in colour mode "
                         f"{_NAMES[mode]} (PIL: not enough channels)")
    cmd = f.read(f.number(4, "colour-mode section"))
    size = f.number(4, "resource section")
    end = f.pos + size
    while f.pos < end:
        f.read(4)                                   # signature
        f.number(2, "resource id")
        b = f.read(1)
        if not b:
            raise GiveWay(f"{path}: PSD resource name cut short")
        name = f.read(b[0])
        if not len(name) & 1:
            f.read(1)
        if len(f.read(f.number(4, "resource size"))) & 1:
            f.read(1)
    size = f.number(4, "layer section")
    if size:
        end = f.pos + size
        f.number(4, "layer info")
        f.pos = end
    if w == 0 or h == 0:
        raise GiveWay(f"{path}: PSD of {w}x{h} pixels (PIL: not identified)")
    return w, h, mode, bits, channels, cmd, f


def _decode(data: bytes, path: str, rows) -> np.ndarray:
    w, h, mode, bits, channels, cmd, f = header(data, path)
    pil_mode, keep = MODES[mode, bits]
    compression = f.number(2, "compression")
    if pil_mode == "LAB":
        raise ValueError(f"{path}: a Lab PSD, which PIL opens as mode LAB and the JAX reader "
                         "trains as R, G, B (fault B26); not read")
    if pil_mode == "P" and len(cmd) != 768:
        raise ValueError(f"{path}: an indexed PSD whose colour-mode data is {len(cmd)} bytes, "
                         "not a 768-byte colour table")
    if pil_mode == "RGB" and channels == 4:
        keep = 4
    if compression not in (0, 1):
        raise ValueError(f"{path}: a PSD composite of compression {compression} (ZIP), which "
                         "PIL cannot load (cannot load this image)")
    row = (w + 7) // 8 if bits == 1 else w
    start = f.pos
    if compression == 0:
        size = row * h * keep
        if len(data) - start < size:
            raise ValueError(f"{path}: PSD composite data cut short (image file is truncated)")
        planes = np.frombuffer(data, np.uint8, size, start).reshape(keep, h, row)
    else:
        if len(data) - start < 2 * channels * h:
            raise ValueError(f"{path}: PSD PackBits counts cut short (image file is truncated)")
        counts = np.frombuffer(data, ">u2", keep * h, start).astype(np.int64)
        at = start + 2 * channels * h + np.cumsum(counts) - counts
        if at[-1] + counts[-1] > len(data):
            raise ValueError(f"{path}: PSD PackBits rows cut short (image file is truncated)")
        planes, failed = rows(data, at.tolist(), counts.tolist(), row)
        if failed:
            k, got = failed
            where = f"{path}: PSD PackBits row {k % h} of channel {k // h}"
            if got < 0:
                raise ValueError(f"{where} decodes past the {row} bytes it should fill")
            raise ValueError(f"{where} gives {got} of its {row} bytes")
        planes = planes.reshape(keep, h, row)
    if bits == 1:
        return np.where(np.unpackbits(planes[0], axis=1)[:, :w] == 1, 0, 255).astype(np.uint8)
    img = planes.transpose(1, 2, 0)
    if pil_mode == "P":
        return np.frombuffer(cmd, np.uint8).reshape(3, 256).T[img[..., 0]]
    if pil_mode == "CMYK":
        return cmyk_to_rgb(255 - img)
    return np.ascontiguousarray(img[..., 0] if keep == 1 else img)


# ------------------------------------------------------------------ writer

def encode_psd(img: np.ndarray, mode: int | None = None, palette: np.ndarray | None = None,
               packbits: bool = False, extra: int = 0) -> bytes:
    """An image -> the bytes of a PSD's composite, planes as given: colour
    mode 0 (bitmap: (H, W), 0 white and anything else black, 1 bit),
    1 / 7 / 8 ((H, W) or (H, W, C) planes), 2 ((H, W) indices into
    `palette`, (256, 3)), 3 (RGB or RGBA), 4 ((H, W, 4) CMYK, stored
    inverted) or 9 ((H, W, 3) Lab). `extra` more channels of 255 follow.
    PackBits rows (`io/tiff.py::packbits_rows`) where `packbits`."""
    img = np.asarray(img, np.uint8)
    if mode is None:
        mode = 1 if img.ndim == 2 else 3
    planes = img[None] if img.ndim == 2 else img.transpose(2, 0, 1)
    h, w = planes.shape[1:]
    bits = 8
    if mode == 0:
        bits = 1
        planes = np.packbits(planes != 0, axis=2)
    elif mode == 4:
        planes = 255 - planes
    if extra:
        planes = np.concatenate([planes, np.full((extra,) + planes.shape[1:], 255, np.uint8)])
    cmd = b"" if mode != 2 else np.asarray(palette, np.uint8).T.tobytes()
    head = (PSD_MAGIC + struct.pack(">H6xHIIHH", 1, len(planes), h, w, bits, mode)
            + struct.pack(">I", len(cmd)) + cmd + struct.pack(">II", 0, 0))
    if not packbits:
        return head + struct.pack(">H", 0) + planes.tobytes()
    body, lengths = tiff.packbits_rows(planes.reshape(-1, planes.shape[2]))
    return head + struct.pack(">H", 1) + lengths.astype(">u2").tobytes() + body


def write_psd(path: str, img: np.ndarray, **kwargs) -> None:
    """`encode_psd(img, **kwargs)` written to `path` (its directory made if
    needed)."""
    data = encode_psd(img, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
