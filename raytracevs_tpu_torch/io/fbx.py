"""FBX mesh import (binary + ASCII FBX 7.x) with the reference's
preprocessing.

Numpy copy of raytracevs_tpu/io/fbx.py. Stand-in for the reference's
Assimp pipeline (MeshCacheService.cs:391-427): Triangulate +
GenerateSmoothNormals + JoinIdenticalVertices + MakeLeftHanded +
FlipWindingOrder, merging all geometries into one vertex/index pool. It
parses the FBX itself (the JAX package's optional trimesh/pyassimp route is
left out, so the import never depends on what is installed): both the
"Kaydara FBX Binary" container (the common export flavor; the reference
detects it at MeshCacheService.cs:370-385 and its own troubleshooting text
tells users to re-export as "FBX 7.4 binary") and ASCII 7.x (the
reference's WineGlass.fbx is ASCII 7.3). Vertices are read
as raw control points (the reference merges scene.Meshes without applying
node transforms, MeshCacheService.cs:446-513).
"""
from __future__ import annotations

import re
import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class ImportedMesh:
    vertices: np.ndarray  # [V,3] float32 positions
    normals: np.ndarray  # [V,3] float32 smooth vertex normals
    indices: np.ndarray  # [T*3] uint32 triangle indices
    bounds_min: np.ndarray
    bounds_max: np.ndarray


class _Node:
    __slots__ = ("name", "props", "children")

    def __init__(self, name, props):
        self.name = name
        self.props = props
        self.children: List[_Node] = []

    def find_all(self, name):
        return [c for c in self.children if c.name == name]

    def find(self, name):
        for c in self.children:
            if c.name == name:
                return c
        return None


_TOKEN_RE = re.compile(
    r"""
    (?P<comment>;[^\n]*) |
    (?P<name>[A-Za-z_][A-Za-z0-9_]*\s*:) |
    (?P<string>"(?:[^"\\]|\\.)*") |
    (?P<number>[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?) |
    (?P<star>\*\d+) |
    (?P<open>\{) |
    (?P<close>\}) |
    (?P<comma>,)
    """,
    re.VERBOSE,
)


def _parse_ascii_fbx(text: str) -> _Node:
    root = _Node("", [])
    stack = [root]
    current: Optional[_Node] = None
    for m in _TOKEN_RE.finditer(text):
        kind = m.lastgroup
        tok = m.group()
        if kind == "comment" or kind == "comma":
            continue
        if kind == "name":
            node = _Node(tok[:-1].strip(), [])
            stack[-1].children.append(node)
            current = node
        elif kind == "open":
            stack.append(current if current is not None else _Node("?", []))
            current = None
        elif kind == "close":
            stack.pop()
            current = None
        elif current is not None:
            if kind == "string":
                current.props.append(tok[1:-1])
            elif kind == "number":
                current.props.append(float(tok) if ("." in tok or "e" in tok or "E" in tok)
                                     else int(tok))
            # star tokens (*N array sizes) are implicit; values come via 'a:'
    return root


def _collect_array(node: _Node) -> np.ndarray:
    """ASCII FBX 7.x arrays nest as `X: *N { a: v,v,v,... }`; the binary
    parser stores the decoded ndarray directly as the node's property."""
    if node.props and isinstance(node.props[0], np.ndarray):
        return node.props[0].astype(np.float64)
    a = node.find("a")
    vals = a.props if a is not None else node.props
    return np.asarray(vals, dtype=np.float64)


# ---------------------------------------------------------------------------
# Binary FBX ("Kaydara FBX Binary") container
# ---------------------------------------------------------------------------
BINARY_FBX_MAGIC = b"Kaydara FBX Binary"

_SCALAR_PROPS = {  # type char -> struct format
    "Y": "<h", "C": "<B", "I": "<i", "F": "<f", "D": "<d", "L": "<q",
}
_ARRAY_PROPS = {  # type char -> numpy dtype
    "f": np.float32, "d": np.float64, "i": np.int32, "l": np.int64,
    "b": np.uint8,
}


def _parse_binary_fbx(data: bytes) -> _Node:
    """Decode the binary FBX node tree into the same _Node shape the ASCII
    parser builds (geometry extraction is shared).

    Container layout: 23-byte magic header, u32 LE version at offset 23,
    then a flat list of node records. Each record is (EndOffset,
    NumProperties, PropertyListLen) — u32 for version < 7500, u64 from
    7500 — a u8 name length + name, the typed property list, nested child
    records, and a zeroed sentinel record closing each child list. Array
    properties carry (Length, Encoding, ByteLen) with Encoding 1 =
    zlib-deflate.
    """
    version = struct.unpack_from("<I", data, 23)[0]
    wide = version >= 7500
    head_fmt = "<QQQ" if wide else "<III"
    head_len = 24 if wide else 12

    def read_node(off):
        end, nprops, plen = struct.unpack_from(head_fmt, data, off)
        off += head_len
        nlen = data[off]
        off += 1
        name = data[off : off + nlen].decode("ascii", "replace")
        off += nlen
        if end == 0:  # sentinel record: closes the enclosing child list
            return None, off
        node = _Node(name, [])
        prop_end = off + plen
        for _ in range(nprops):
            t = chr(data[off])
            off += 1
            if t in _SCALAR_PROPS:
                fmt = _SCALAR_PROPS[t]
                (v,) = struct.unpack_from(fmt, data, off)
                off += struct.calcsize(fmt)
                node.props.append(bool(v) if t == "C" else v)
            elif t in _ARRAY_PROPS:
                n, enc, blen = struct.unpack_from("<III", data, off)
                off += 12
                dt = np.dtype(_ARRAY_PROPS[t]).newbyteorder("<")
                if enc == 1:
                    raw = zlib.decompress(data[off : off + blen])
                else:
                    blen = n * dt.itemsize
                    raw = data[off : off + blen]
                off += blen
                node.props.append(np.frombuffer(raw, dtype=dt, count=n))
            elif t in ("S", "R"):
                (blen,) = struct.unpack_from("<I", data, off)
                off += 4
                raw = data[off : off + blen]
                off += blen
                node.props.append(
                    raw.decode("utf-8", "replace") if t == "S" else raw)
            else:
                raise ValueError(f"unknown FBX property type {t!r} at {off}")
        off = prop_end
        while off < end:
            child, off = read_node(off)
            if child is None:
                break
            node.children.append(child)
        return node, end

    root = _Node("", [])
    off = 27
    while off + head_len + 1 <= len(data):
        node, off = read_node(off)
        if node is None:
            break
        root.children.append(node)
    return root


def _triangulate(poly_indices: np.ndarray) -> np.ndarray:
    """FBX PolygonVertexIndex -> fan-triangulated index list.

    Negative values mark polygon ends (idx = ~value).
    """
    tris: List[int] = []
    poly: List[int] = []
    for v in poly_indices.astype(np.int64):
        if v < 0:
            poly.append(int(~v))
            for i in range(1, len(poly) - 1):
                tris.extend((poly[0], poly[i], poly[i + 1]))
            poly = []
        else:
            poly.append(int(v))
    return np.asarray(tris, dtype=np.uint32)


def compute_smooth_normals(vertices: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals (GenerateSmoothNormals analog)."""
    tris = indices.reshape(-1, 3).astype(np.int64)
    v0 = vertices[tris[:, 0]]
    v1 = vertices[tris[:, 1]]
    v2 = vertices[tris[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # unnormalized = area-weighted
    normals = np.zeros_like(vertices)
    for c in range(3):
        np.add.at(normals, tris[:, c], fn)
    length = np.linalg.norm(normals, axis=1, keepdims=True)
    return (normals / np.where(length < 1e-12, 1.0, length)).astype(np.float32)


def _left_handed(vertices: np.ndarray, indices: np.ndarray):
    """MakeLeftHanded (negate Z) + FlipWindingOrder (reverse triangles)."""
    v = vertices.copy()
    v[:, 2] = -v[:, 2]
    tris = indices.reshape(-1, 3)[:, ::-1]
    return v, tris.reshape(-1).astype(np.uint32)


def _weld_vertices(vertices: np.ndarray, indices: np.ndarray):
    """JoinIdenticalVertices: merge duplicate positions, remap indices."""
    rounded = np.round(vertices.astype(np.float64), 8)
    uniq, remap = np.unique(rounded, axis=0, return_inverse=True)
    # keep original (unrounded) coordinates of the first occurrence
    first = np.full(len(uniq), -1, np.int64)
    for i, u in enumerate(remap):
        if first[u] < 0:
            first[u] = i
    welded = vertices[first]
    return welded.astype(np.float32), remap[indices.astype(np.int64)].astype(np.uint32)


def load_fbx(path: str) -> ImportedMesh:
    """Import an FBX file, merging all geometries (MeshCacheService semantics).

    Accepts both container flavors, like the reference's Assimp path
    (MeshCacheService.cs:270-385): binary ("Kaydara FBX Binary" magic) and
    ASCII 7.x.
    """
    with open(path, "rb") as f:
        raw = f.read()
    if raw.startswith(BINARY_FBX_MAGIC):
        root = _parse_binary_fbx(raw)
    else:
        text = raw.decode("utf-8", errors="replace")
        if not text.lstrip().startswith(";") and "FBX" not in text[:256]:
            raise ValueError(f"not an FBX file: {path}")
        root = _parse_ascii_fbx(text)
    objects = root.find("Objects")
    if objects is None:
        raise ValueError(f"no Objects section in FBX: {path}")

    all_vertices: List[np.ndarray] = []
    all_indices: List[np.ndarray] = []
    base = 0
    for geo in objects.find_all("Geometry"):
        vnode = geo.find("Vertices")
        inode = geo.find("PolygonVertexIndex")
        if vnode is None or inode is None:
            continue
        verts = _collect_array(vnode).reshape(-1, 3)
        tris = _triangulate(_collect_array(inode))
        all_vertices.append(verts)
        all_indices.append(tris + base)
        base += len(verts)
    if not all_vertices:
        raise ValueError(f"no mesh geometry in FBX: {path}")

    vertices = np.concatenate(all_vertices, axis=0).astype(np.float32)
    indices = np.concatenate(all_indices, axis=0)
    vertices, indices = _weld_vertices(vertices, indices)
    vertices, indices = _left_handed(vertices, indices)
    normals = compute_smooth_normals(vertices, indices)
    return ImportedMesh(
        vertices=vertices,
        normals=normals,
        indices=indices,
        bounds_min=vertices.min(axis=0),
        bounds_max=vertices.max(axis=0),
    )
