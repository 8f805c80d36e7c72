"""X11 pixmaps (XPM) in numpy, to the arrays PIL 12 gives where PIL reads
them right (the JAX reader opens dataset images with PIL; the machines the
port runs on have none).

`read_xpm` reads the file as PIL's `XpmImagePlugin` does, line by line
after the `/* XPM */` magic:

- the first line that starts `"<width> <height> <ncolors> <cpp>` (no line
  matching it gives way, `io/giveway.py`, as does a size of 0);
- `ncolors` colour lines: the key is the `cpp` characters after the line's
  first, and the text up to the line's last two characters holds pairs of
  a context and a colour, of which the first `c` is taken (none raises
  PIL's "cannot read this XPM file"; a `c` with no colour gives way);
  `None` is the transparent colour, which PIL keeps out of the palette;
- the pixel lines: every later line but one `/* pixels */`, each the text
  between its first and last `"`, cut into keys of `cpp` characters,
  until `width * height` pixels are read (PIL reads whole lines, and holds
  no line to the width: a line's pixels run into the next row).

The image is RGB: PIL opens a file of at most 256 colours as mode P, whose
`np.asarray` is the indices the JAX reader trains on (fault B15), and more
as RGB; `read_xpm` gives each pixel its colour, as `convert("RGB")` does.

Colours are X11's `#` forms, read as X11's `XParseColor` reads them: 3, 6,
9 or 12 hex digits, a third each for R, G and B, of which the top 8 bits
are kept. PIL takes the low 24 bits of the number, which is right for 6
digits and wrong for the rest (`#F00` is (0, 15, 0), `#FFFF00000000`
black: fault B25); another count of digits raises. A named colour (`c
red`), a pixel of the `None` colour or of no key of the file's, and too
few pixels raise with PIL's cause, as PIL raises on each.

The keys are matched in numpy (each key's bytes packed into one integer,
looked up in a table of every key at 1 or 2 characters a pixel, else
among the file's sorted keys), so there is no C++ route.
`encode_xpm` / `write_xpm` write the form X11's `XpmWriteFileFromImage`
writes, for the tests and `chip_smoke.py`; the training path does not
write XPM.
"""

from __future__ import annotations

import os
import re

import numpy as np

from gaussianmesh_tpu_torch.io.giveway import GiveWay

XPM_MAGIC = b"/* XPM */"
_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')    # PIL's `xpm_head`
_HEXDIGITS = re.compile(rb"[0-9a-fA-F]*")
# the key characters of `encode_xpm`: printable ASCII but `"` and `\`
KEY_CHARS = bytes(c for c in range(32, 127) if c not in b'"\\')


def read_xpm(path: str) -> np.ndarray:
    """An XPM -> uint8 (H, W, 3)."""
    with open(path, "rb") as f:
        return decode_xpm(f.read(), path)


def x11_colour(spec: bytes, path: str = "<bytes>") -> tuple[int, int, int]:
    """An X11 `#` colour (`#RGB`, `#RRGGBB`, `#RRRGGGBBB` or
    `#RRRRGGGGBBBB`) -> its 8-bit (R, G, B): the top 8 bits of each."""
    digits = spec[1:]
    if not _HEXDIGITS.fullmatch(digits) or len(digits) not in (3, 6, 9, 12):
        raise ValueError(f"{path}: XPM colour {spec.decode('latin-1')!r} is none of X11's "
                         "#RGB forms (3, 6, 9 or 12 hex digits)")
    n = len(digits) // 3
    values = (int(digits[k * n:(k + 1) * n], 16) for k in range(3))
    return tuple(v << 4 if n == 1 else v >> 4 * n - 8 for v in values)


class _Lines:
    """`readline` over bytes, as a binary file's."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def readline(self) -> bytes:
        end = self.data.find(b"\n", self.pos)
        end = len(self.data) if end < 0 else end + 1
        line, self.pos = self.data[self.pos:end], end
        return line


def header(data: bytes, path: str = "<bytes>"):
    """An XPM's header and colour lines as PIL's `_open` reads them ->
    (width, height, cpp, {key: (R, G, B)} in the order PIL indexes them,
    the transparent key or None, where the pixel lines start); raises or
    gives way where `_open` does."""
    if not data.startswith(XPM_MAGIC):
        raise GiveWay(f"{path}: not an XPM file")
    lines = _Lines(data, len(XPM_MAGIC))
    while True:
        line = lines.readline()
        if not line:
            raise GiveWay(f"{path}: broken XPM file (no values line)")
        m = _HEAD.match(line)
        if m:
            break
    try:
        w, h, ncolors, cpp = (int(g) for g in m.groups())
    except ValueError:
        raise ValueError(f"{path}: XPM values line {line.strip()!r} has an empty number "
                         "(PIL: invalid literal for int())") from None
    palette, transparent = {}, None
    for _ in range(ncolors):
        line = lines.readline().rstrip()
        key, s = line[1:cpp + 1], line[cpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                if i + 1 == len(s):
                    raise GiveWay(f"{path}: XPM colour line {line!r} has a c with no colour")
                rgb = s[i + 1]
                if rgb == b"None":
                    transparent = key
                elif rgb.startswith(b"#"):
                    palette[key] = x11_colour(rgb, path)
                else:
                    raise ValueError(f"{path}: XPM colour {rgb.decode('latin-1')!r} by name "
                                     "(PIL: cannot read this XPM file)")
                break
        else:
            raise ValueError(f"{path}: XPM colour line {line[:40]!r} has no c colour (PIL: "
                             "cannot read this XPM file)")
    if w == 0 or h == 0:
        raise GiveWay(f"{path}: XPM of {w}x{h} pixels (PIL: not identified)")
    if cpp == 0:
        raise ValueError(f"{path}: XPM of 0 characters a pixel (PIL: range() arg 3 must not "
                         "be zero)")
    return w, h, cpp, palette, transparent, lines.pos


def _codes(keys: np.ndarray) -> np.ndarray:
    """(N, cpp) uint8 keys, cpp > 2 -> one int64 a key where cpp <= 8 (its
    bytes as a big-endian number), else the keys' rows as void scalars
    (both compare as the keys do)."""
    n, cpp = keys.shape
    if cpp <= 8:
        code = np.zeros(n, np.int64)
        for k in range(cpp):
            code = code << 8 | keys[:, k]
        return code
    return np.ascontiguousarray(keys).view(np.dtype((np.void, cpp)))[:, 0]


def decode_xpm(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_xpm` of an XPM's bytes (`path` names it in errors)."""
    w, h, cpp, palette, transparent, pos = header(data, path)
    need = w * h
    lines = _Lines(data, pos)
    bodies, got, pixel_header = [], 0, False
    while got < need:
        line = lines.readline()
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not pixel_header:
            pixel_header = True
            continue
        body = b'"'.join(line.split(b'"')[1:-1])
        if len(body) % cpp:
            raise ValueError(f"{path}: an XPM pixel line of {len(body)} characters, not keys of "
                             f"{cpp} (PIL: a key of no colour)")
        bodies.append(body)
        got += len(body) // cpp
    keys = np.frombuffer(b"".join(bodies), np.uint8).reshape(-1, cpp)
    known = np.frombuffer(b"".join(palette), np.uint8).reshape(-1, cpp)
    colours = np.array(list(palette.values()), np.uint8).reshape(-1, 3)
    if cpp <= 2:                                  # a table of every key
        table = np.full(256 ** cpp, -1, np.int64)
        table[known.view(f">u{cpp}")[:, 0]] = np.arange(len(known))
        at = table[keys.view(f">u{cpp}")[:, 0]]
        found = at >= 0
    else:
        code, known_code = _codes(keys), _codes(known)
        order = np.argsort(known_code, kind="stable")
        found = np.zeros(len(code), bool)
        at = np.zeros(len(code), np.int64)
        if len(order):
            at = np.minimum(np.searchsorted(known_code[order], code), len(order) - 1)
            found = known_code[order][at] == code
            at = order[at]
    if not found.all():
        bad = keys[np.argmin(found)].tobytes()
        why = ("the None (transparent) colour, which PIL cannot load" if bad == transparent
               else "no colour of the file's (PIL: x not in tuple / KeyError)")
        raise ValueError(f"{path}: XPM pixel {bad!r}: {why}")
    if len(keys) < need:
        raise ValueError(f"{path}: XPM pixel lines give {len(keys)} of {need} pixels (PIL: not "
                         "enough image data)")
    return colours[at[:need]].reshape(h, w, 3)


def encode_xpm(img: np.ndarray, palette: np.ndarray | None = None, cpp: int | None = None,
               digits: int = 6, name: str = "im") -> bytes:
    """An image -> the bytes of an XPM: `img` (H, W) indices into `palette`
    ((N, 3) uint8), or (H, W, 3) RGB (its distinct colours the palette, in
    the order `np.unique` sorts them). Keys of `cpp` characters of
    KEY_CHARS (the fewest that hold the palette where None), colours as
    `#` and `digits` (3, 6, 9 or 12) hex digits, 8-bit values repeated as
    X11 reads them back (3 digits: the top 4 bits only)."""
    img = np.asarray(img)
    if palette is None:
        flat = img.reshape(-1, 3)
        palette, idx = np.unique(flat, axis=0, return_inverse=True)
        idx = idx.reshape(img.shape[:2])
    else:
        idx = img
    palette = np.asarray(palette, np.uint8)
    n = len(palette)
    base = len(KEY_CHARS)
    if cpp is None:
        cpp = 1
        while base ** cpp < n:
            cpp += 1
    chars = np.frombuffer(KEY_CHARS, np.uint8)
    keys = np.stack([chars[np.arange(n) // base ** k % base] for k in range(cpp)], 1)
    h, w = idx.shape
    per = digits // 3

    def hexes(v):
        wide = (int(v) << 8 | int(v)) >> (16 - 4 * per)     # X11 scales back by repeating
        return f"{wide:0{per}X}"
    out = [b"/* XPM */\nstatic char *%s[] = {\n/* columns rows colors chars-per-pixel */\n"
           % name.encode(), b'"%d %d %d %d",\n' % (w, h, n, cpp)]
    for k in range(n):
        out.append(b'"%s c #%s",\n' % (keys[k].tobytes(),
                                       "".join(hexes(v) for v in palette[k]).encode()))
    out.append(b"/* pixels */\n")
    rows = np.full((h, w * cpp + 4), ord(","), np.uint8)
    rows[:, 0] = rows[:, -3] = ord('"')
    rows[:, 1:-3] = keys[idx].reshape(h, -1)
    rows[:, -1] = ord("\n")
    body = rows.tobytes()
    return b"".join(out) + body[:-2] + b"\n};\n"


def write_xpm(path: str, img: np.ndarray, **kwargs) -> None:
    """`encode_xpm(img, **kwargs)` written to `path` (its directory made if
    needed)."""
    data = encode_xpm(img, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
