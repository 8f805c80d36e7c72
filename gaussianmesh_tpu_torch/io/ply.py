"""Minimal self-contained PLY reader/writer (numpy, no plyfile dependency).

Supports the subsets the framework needs: binary_little_endian and ascii,
scalar float/int vertex properties, and uchar-counted int face lists —
enough to round-trip the reference's Gaussian PLY schema
(scene/mesh_based_gaussian_model.py:290-332) and triangle meshes.
"""

from __future__ import annotations

import io as _io
from dataclasses import dataclass, field

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_INV_TYPES = {"f4": "float", "f8": "double", "i4": "int", "u4": "uint",
              "u1": "uchar", "i1": "char", "i2": "short", "u2": "ushort"}


@dataclass
class PlyElement:
    name: str
    count: int
    properties: list = field(default_factory=list)  # (name, dtype) or ("list", count_dt, item_dt, name)


def _parse_header(f) -> tuple[list[PlyElement], str]:
    line = f.readline().strip()
    if line != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements: list[PlyElement] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tok = line.decode("ascii", "replace").strip().split()
        if not tok or tok[0] == "comment":
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append(PlyElement(tok[1], int(tok[2])))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1].properties.append(
                    ("list", _TYPES[tok[2]], _TYPES[tok[3]], tok[4]))
            else:
                elements[-1].properties.append((tok[2], _TYPES[tok[1]]))
        elif tok[0] == "end_header":
            break
    if fmt not in ("binary_little_endian", "ascii"):
        raise ValueError(f"unsupported PLY format {fmt}")
    return elements, fmt


def read_ply(path: str) -> dict[str, dict[str, np.ndarray]]:
    """Returns {element_name: {property_name: array}}; list properties come
    back as (count, k) arrays when uniform (e.g. triangle faces)."""
    with open(path, "rb") as f:
        elements, fmt = _parse_header(f)
        out: dict[str, dict[str, np.ndarray]] = {}
        for el in elements:
            has_list = any(p[0] == "list" for p in el.properties)
            if not has_list:
                dt = np.dtype([(name, "<" + t) for name, t in el.properties])
                if fmt == "binary_little_endian":
                    data = np.frombuffer(f.read(dt.itemsize * el.count), dtype=dt,
                                         count=el.count)
                else:
                    rows = [f.readline().split() for _ in range(el.count)]
                    data = np.array([tuple(r) for r in rows], dtype=dt)
                out[el.name] = {name: np.array(data[name]) for name, _ in el.properties}
            else:
                # general case: parse row by row (faces are small)
                rows: dict[str, list] = {p[-1]: [] for p in el.properties}
                for _ in range(el.count):
                    if fmt == "ascii":
                        vals = f.readline().split()
                        i = 0
                        for p in el.properties:
                            if p[0] == "list":
                                n = int(vals[i]); i += 1
                                rows[p[3]].append([float(v) for v in vals[i:i + n]])
                                i += n
                            else:
                                rows[p[0]].append(float(vals[i])); i += 1
                    else:
                        for p in el.properties:
                            if p[0] == "list":
                                cnt_dt = np.dtype("<" + p[1])
                                n = int(np.frombuffer(f.read(cnt_dt.itemsize),
                                                      cnt_dt)[0])
                                item_dt = np.dtype("<" + p[2])
                                rows[p[3]].append(np.frombuffer(
                                    f.read(item_dt.itemsize * n), item_dt, n))
                            else:
                                dt = np.dtype("<" + p[1])
                                rows[p[0]].append(np.frombuffer(
                                    f.read(dt.itemsize), dt)[0])
                out[el.name] = {}
                for name, vals in rows.items():
                    try:
                        out[el.name][name] = np.asarray(vals)
                    except ValueError:
                        out[el.name][name] = np.asarray(vals, dtype=object)
    return out


def write_ply(path: str, elements: dict[str, dict[str, np.ndarray]],
              list_properties: dict[str, list[str]] | None = None) -> None:
    """elements: {element_name: {prop: (N,) or (N, k) array}}. Properties in
    `list_properties[element]` are written as uchar-counted lists (faces);
    other (N, k) arrays must be pre-flattened into separate scalar props."""
    list_properties = list_properties or {}
    buf = _io.BytesIO()
    header = ["ply", "format binary_little_endian 1.0"]
    bodies = []
    for el_name, props in elements.items():
        lists = list_properties.get(el_name, [])
        count = len(next(iter(props.values())))
        header.append(f"element {el_name} {count}")
        scalar_names = [n for n in props if n not in lists]
        for n in scalar_names:
            a = np.asarray(props[n])
            assert a.ndim == 1, f"flatten {el_name}/{n} first"
            header.append(f"property {_INV_TYPES[a.dtype.str[1:]]} {n}")
        for n in lists:
            a = np.asarray(props[n])
            header.append(f"property list uchar {_INV_TYPES[a.dtype.str[1:]]} {n}")
        if lists:
            body = _io.BytesIO()
            arrs = {n: np.asarray(props[n]) for n in props}
            for i in range(count):
                for n in scalar_names:
                    body.write(arrs[n][i].tobytes())
                for n in lists:
                    row = arrs[n][i]
                    body.write(np.uint8(len(row)).tobytes())
                    body.write(row.tobytes())
            bodies.append(body.getvalue())
        else:
            dt = np.dtype([(n, np.asarray(props[n]).dtype.str) for n in scalar_names])
            rec = np.empty(count, dtype=dt)
            for n in scalar_names:
                rec[n] = props[n]
            bodies.append(rec.tobytes())
    header.append("end_header")
    buf.write(("\n".join(header) + "\n").encode("ascii"))
    for b in bodies:
        buf.write(b)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
