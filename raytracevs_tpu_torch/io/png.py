"""Minimal pure-Python PNG reader (no PIL dependency), for the blue-noise asset."""
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
