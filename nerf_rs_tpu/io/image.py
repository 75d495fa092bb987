"""Image I/O: PPM (binary P6), PNG, and RGBA buffers.

Quantization replicates the reference exactly: clamp to [0,1], scale by 255,
add 0.5, truncate to u8 (save_ppm /root/reference/src/lib.rs:567-580,
pixels_to_rgba lib.rs:582-592).

PNG is encoded and decoded here with the standard library's zlib: 8-bit
RGB/RGBA, non-interlaced — the form renders are written in and the
nerf_synthetic dataset ships in.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {2: 3, 6: 4}   # color type -> channels (RGB, RGBA)


def quantize_u8(pixels: np.ndarray) -> np.ndarray:
    """clamp(0,1) * 255 + 0.5, truncated — byte-identical to the reference."""
    px = np.asarray(pixels, dtype=np.float32)
    return (np.clip(px, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_ppm(path, pixels: np.ndarray, height: int, width: int) -> None:
    """Binary P6 PPM writer (reference save_ppm, lib.rs:568-580)."""
    rgb = quantize_u8(np.asarray(pixels).reshape(height, width, 3))
    try:
        from nerf_rs_tpu.io import native

        if native.available():
            native.write_ppm(str(path), rgb)
            return
    except Exception:
        pass
    with open(path, "wb") as f:
        f.write(f"P6\n{width} {height}\n255\n".encode())
        f.write(rgb.tobytes())


def load_ppm(path) -> np.ndarray:
    """Read a binary P6 PPM into a float32 (H, W, 3) array in [0, 1]."""
    data = Path(path).read_bytes()
    # Parse header: magic, width, height, maxval — whitespace/comment tolerant.
    tokens = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i] != 0x0A:
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    if tokens[0] != b"P6":
        raise ValueError(f"not a binary PPM: magic {tokens[0]!r}")
    width, height, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    i += 1  # single whitespace after maxval
    raw = np.frombuffer(data, dtype=np.uint8, count=width * height * 3, offset=i)
    return raw.reshape(height, width, 3).astype(np.float32) / float(maxval)


def pixels_to_rgba(pixels: np.ndarray) -> np.ndarray:
    """Flat RGBA u8 buffer with A=255 (reference pixels_to_rgba, lib.rs:582-592).

    Serving hot path (api.render_image_rgba -> every viewer frame): uses
    the threaded C quantize+interleave when built, numpy otherwise —
    byte-identical either way (tests/test_io.py)."""
    px = np.asarray(pixels, dtype=np.float32).reshape(-1, 3)
    try:
        from nerf_rs_tpu.io import native

        if native.available():
            return native.rgb_to_rgba(px)
    except Exception:
        pass
    rgb = quantize_u8(px)
    rgba = np.empty((rgb.shape[0], 4), dtype=np.uint8)
    rgba[:, :3] = rgb
    rgba[:, 3] = 255
    return rgba.reshape(-1)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3|4) uint8 -> PNG bytes. Every row uses the Up filter
    (byte-wise difference to the row above), computed in one array op."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4) uint8, got {img.shape}")
    h, w, c = img.shape
    rows = img.reshape(h, w * c)
    up = rows - np.concatenate([np.zeros((1, w * c), np.uint8), rows[:-1]])
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (_PNG_SIG + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3|4) uint8, for 8-bit RGB/RGBA non-interlaced
    images (all five row filters). Raises ValueError for anything else.
    Average and Paeth rows are undone byte by byte in Python; None, Sub
    and Up rows are array ops."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {tag!r}: CRC mismatch")
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG (bit depth {depth}, color type "
                         f"{ctype}, interlace {interlace}): only 8-bit "
                         "RGB/RGBA non-interlaced")
    c = _PNG_CHANNELS[ctype]
    stride = w * c
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, row = rows[y, 0], rows[y, 1:]
        if ft == 0:
            cur = row.copy()
        elif ft == 1:      # Sub: running sum per channel, mod 256
            cur = np.cumsum(row.reshape(w, c), axis=0, dtype=np.uint8).reshape(-1)
        elif ft == 2:      # Up
            cur = row + prev
        elif ft in (3, 4):  # Average, Paeth: sequential along the row
            r, p = row.tolist(), prev.tolist()
            for i in range(stride):
                a = r[i - c] if i >= c else 0
                if ft == 3:
                    r[i] = (r[i] + ((a + p[i]) >> 1)) & 0xFF
                else:
                    cc = p[i - c] if i >= c else 0
                    r[i] = (r[i] + _paeth(a, p[i], cc)) & 0xFF
            cur = np.asarray(r, np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ft}")
        out[y] = prev = cur
    return out.reshape(h, w, c)


def read_png(path) -> np.ndarray:
    """Read a PNG file as (H, W, 3|4) uint8 (decode_png)."""
    return decode_png(Path(path).read_bytes())


def save_png(path, pixels: np.ndarray, height: int, width: int) -> None:
    """Quantize (quantize_u8) and write an RGB PNG."""
    rgb = quantize_u8(np.asarray(pixels).reshape(height, width, 3))
    Path(path).write_bytes(encode_png(rgb))


def load_png(path) -> np.ndarray:
    """Read a PNG into a float32 (H, W, 3) array in [0, 1] (alpha dropped)."""
    return read_png(path)[..., :3].astype(np.float32) / 255.0
