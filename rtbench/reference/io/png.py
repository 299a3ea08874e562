"""Minimal pure-Python PNG reader and writer (no PIL dependency): the
blue-noise asset, and the CLI's output where PIL is not installed. The
writer is copied from raytracevs_tpu/io/png.py."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG into a uint8 [H,W,C] array.

    Supports color types 0 (gray), 2 (RGB), 4 (gray+alpha), 6 (RGBA) and
    all five scanline filters — enough for texture assets such as the
    reference's Resource/Texture/BlueNoise16.png (16x16 RGBA8, loaded as
    R8G8B8A8_UNORM in DXRPipeline.cpp:1517-1613).
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")

    width = height = bit_depth = color_type = interlace = None
    idat = []
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            width, height, bit_depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", body
            )
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length

    if width is None:
        raise ValueError(f"{path}: missing IHDR")
    if bit_depth != 8 or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {bit_depth}, interlace {interlace})"
        )
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(color_type)
    if channels is None:
        raise ValueError(f"{path}: unsupported color type {color_type}")

    raw = zlib.decompress(b"".join(idat))
    stride = width * channels
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{path}: bad IDAT payload size")

    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        row_start = y * (stride + 1)
        filt = raw[row_start]
        line = np.frombuffer(raw, np.uint8, stride, row_start + 1).astype(np.int32)
        if filt == 0:
            cur = line
        elif filt == 1:  # Sub
            cur = line.copy()
            for x in range(channels, stride):
                cur[x] = (cur[x] + cur[x - channels]) & 0xFF
        elif filt == 2:  # Up
            cur = (line + prev) & 0xFF
        elif filt == 3:  # Average
            cur = line.copy()
            for x in range(stride):
                left = cur[x - channels] if x >= channels else 0
                cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif filt == 4:  # Paeth
            cur = line.copy()
            for x in range(stride):
                a = cur[x - channels] if x >= channels else 0
                b = prev[x]
                c = prev[x - channels] if x >= channels else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"{path}: unknown filter {filt}")
        out[y] = cur.astype(np.uint8)
        prev = cur

    return out.reshape(height, width, channels)


def encode_png(rgba: np.ndarray, compress_level: int = 6) -> bytes:
    """Encode an RGBA8 [H,W,4] / RGB8 [H,W,3] / gray [H,W] array as PNG bytes."""
    a = np.asarray(rgba, dtype=np.uint8)
    h, w = a.shape[:2]
    channels = a.shape[2] if a.ndim == 3 else 1
    color_type = {1: 0, 3: 2, 4: 6}[channels]

    raw = b"".join(b"\x00" + a[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, compress_level))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, rgba: np.ndarray) -> None:
    """Write an RGBA8 [H,W,4] (or RGB8 [H,W,3]) array as a PNG file."""
    with open(path, "wb") as f:
        f.write(encode_png(rgba))
