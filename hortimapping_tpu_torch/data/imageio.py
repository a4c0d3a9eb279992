"""PNG and TIFF files without OpenCV: the image formats of the wild
pipeline's frames (`<frame>_submap_id.png`, `<frame>_color.png`,
`<frame>_depth.tiff`), read and written with numpy and the standard
library's zlib.

`imread` returns what `cv2.imread(path, cv2.IMREAD_UNCHANGED)` returns for
these files: gray PNG as (H, W) uint8 or uint16, RGB PNG as (H, W, 3) uint8
in BGR order, float32 TIFF as (H, W) float32. `imwrite` takes the same
arrays (3-channel input is BGR) and writes files OpenCV reads back equal.

Supported:
* PNG: gray 8/16-bit and RGB 8-bit, all five row filters, not interlaced.
  Filters 0-2 decode vectorised; average and Paeth rows run a Python loop
  over the row's bytes, so a large image filtered that way reads in about a
  second. The writer uses the "up" filter.
* TIFF: one float32 sample a pixel in strips, either byte order,
  uncompressed or LZW with no predictor or the floating-point predictor.
  The writer writes little-endian, uncompressed, 8-row strips.
Anything else (palette or interlaced PNG, another TIFF compression or
sample type, tiles) raises ValueError naming what it met.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def imread(path: str) -> np.ndarray:
    """The image at `path` (.png, .tif, .tiff), as `cv2.IMREAD_UNCHANGED`."""
    ext = os.path.splitext(path)[1].lower()
    decode = {".png": decode_png, ".tif": decode_tiff, ".tiff": decode_tiff}.get(ext)
    if decode is None:
        raise ValueError(f"{path}: unsupported image extension {ext!r}")
    with open(path, "rb") as f:
        return decode(f.read(), path)


def imwrite(path: str, img: np.ndarray) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        data = encode_png(img)
    elif ext in (".tif", ".tiff"):
        data = encode_tiff(img)
    else:
        raise ValueError(f"{path}: unsupported image extension {ext!r}")
    with open(path, "wb") as f:
        f.write(data)


# ---------------------------------------------------------------- PNG

def _png_chunks(data: bytes, name: str) -> List[Tuple[bytes, bytes]]:
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    chunks, pos = [], 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        chunks.append((kind, data[pos + 8:pos + 8 + n]))
        pos += 12 + n
        if kind == b"IEND":
            break
    return chunks


def _paeth_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def _average_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, H: int, stride: int, bpp: int, name: str) -> np.ndarray:
    buf = np.frombuffer(raw, np.uint8)
    if buf.size < H * (stride + 1):
        raise ValueError(f"{name}: truncated PNG image data")
    rows = buf[:H * (stride + 1)].reshape(H, stride + 1)
    out = np.zeros((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:   # sub: running sum of each byte lane, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:   # up
            cur = line + prev
        elif ftype in (3, 4):
            work = bytearray(line.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(work, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(work), np.uint8)
        else:
            raise ValueError(f"{name}: PNG row {y} has unknown filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes, name: str = "<png>") -> np.ndarray:
    chunks = _png_chunks(data, name)
    if not chunks or chunks[0][0] != b"IHDR":
        raise ValueError(f"{name}: PNG without IHDR")
    W, H, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    channels = {0: 1, 2: 3}.get(ctype)
    if channels is None:
        kinds = {3: "palette", 4: "gray + alpha", 6: "RGBA"}
        raise ValueError(f"{name}: unsupported PNG color type {ctype} "
                         f"({kinds.get(ctype, 'unknown')}); gray and RGB are supported")
    if depth not in (8, 16) or (ctype == 2 and depth != 8):
        raise ValueError(f"{name}: unsupported PNG bit depth {depth} for color type {ctype}")
    if interlace != 0:
        raise ValueError(f"{name}: interlaced (Adam7) PNG is not supported")
    if comp != 0 or filt != 0:
        raise ValueError(f"{name}: unknown PNG compression {comp} / filter method {filt}")
    raw = zlib.decompress(b"".join(body for kind, body in chunks if kind == b"IDAT"))
    bpp = channels * depth // 8
    px = _unfilter(raw, H, W * bpp, bpp, name)
    if depth == 16:
        img = px.view(">u2").astype(np.uint16).reshape(H, W, channels)
    else:
        img = px.reshape(H, W, channels)
    return img[..., 0] if channels == 1 else np.ascontiguousarray(img[..., ::-1])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2 and img.dtype in (np.uint8, np.uint16):
        ctype, depth, px = 0, 8 * img.dtype.itemsize, img[..., None]
    elif img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        ctype, depth, px = 2, 8, img[..., ::-1]   # BGR in, RGB on disk
    else:
        raise ValueError(f"unsupported PNG array: shape {img.shape}, dtype {img.dtype}")
    H, W = img.shape[:2]
    rows = np.ascontiguousarray(px, ">u2" if depth == 16 else np.uint8).view(np.uint8)
    rows = rows.reshape(H, -1)
    up = rows.copy()
    up[1:] -= rows[:-1]                       # "up" filter, mod 256
    filtered = np.concatenate([np.full((H, 1), 2, np.uint8), up], axis=1)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6))
            + _chunk(b"IEND", b""))


# ---------------------------------------------------------------- TIFF

_TIFF_TYPES = {1: "B", 3: "H", 4: "I"}   # BYTE, SHORT, LONG


def _tiff_tags(data: bytes, name: str) -> Tuple[str, Dict[int, List[int]]]:
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None or struct.unpack(order + "H", data[2:4])[0] != 42:
        raise ValueError(f"{name}: not a (classic) TIFF file")
    off = struct.unpack(order + "I", data[4:8])[0]
    n = struct.unpack(order + "H", data[off:off + 2])[0]
    tags: Dict[int, List[int]] = {}
    for i in range(n):
        tag, typ, cnt = struct.unpack(order + "HHI", data[off + 2 + 12 * i:off + 10 + 12 * i])
        fmt = _TIFF_TYPES.get(typ)
        if fmt is None:
            continue   # rational/ascii tags carry nothing the reader needs
        size = struct.calcsize(fmt) * cnt
        at = off + 10 + 12 * i
        if size > 4:
            at = struct.unpack(order + "I", data[at:at + 4])[0]
        tags[tag] = list(struct.unpack(f"{order}{cnt}{fmt}", data[at:at + size]))
    return order, tags


def lzw_decode(data: bytes) -> bytes:
    """TIFF LZW: MSB-first codes of 9-12 bits, clear 256, end 257, the code
    width growing one entry early."""
    out = bytearray()
    table: List[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    width, prev = 9, None
    bitbuf, nbits, pos = 0, 0, 0
    n = len(data)
    while True:
        while nbits < width and pos < n:
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            nbits += 8
        if nbits < width:
            break
        nbits -= width
        code = (bitbuf >> nbits) & ((1 << width) - 1)
        bitbuf &= (1 << nbits) - 1
        if code == 257:
            break
        if code == 256:
            del table[258:]
            width, prev = 9, None
            continue
        if code < len(table):
            entry = table[code]
            if prev is not None:
                table.append(prev + entry[:1])
        elif prev is not None and code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError(f"corrupt LZW stream (code {code}, table {len(table)})")
        out += entry
        prev = entry
        n_codes = len(table)
        width = 12 if n_codes >= 2047 else 11 if n_codes >= 1023 else 10 if n_codes >= 511 else 9
    return bytes(out)


def decode_tiff(data: bytes, name: str = "<tiff>") -> np.ndarray:
    order, tags = _tiff_tags(data, name)
    get = lambda t, d=None: tags.get(t, [d])[0]
    W, H = get(256), get(257)
    bits, fmt, spp = get(258, 1), get(339, 1), get(277, 1)
    comp, pred = get(259, 1), get(317, 1)
    if 322 in tags:
        raise ValueError(f"{name}: tiled TIFF is not supported")
    if (bits, fmt, spp) != (32, 3, 1):
        raise ValueError(f"{name}: unsupported TIFF samples: {spp} a pixel of {bits} bits, "
                         f"SampleFormat {fmt}; one float32 sample is supported")
    if comp not in (1, 5):
        raise ValueError(f"{name}: unsupported TIFF compression {comp}; none (1) and LZW (5) "
                         "are supported")
    if pred not in (1, 3) or (pred == 3 and comp != 5):
        raise ValueError(f"{name}: unsupported TIFF predictor {pred}")
    strips = []
    for off, cnt in zip(tags[273], tags[279]):
        raw = data[off:off + cnt]
        strips.append(lzw_decode(raw) if comp == 5 else raw)
    buf = b"".join(strips)
    if len(buf) < W * H * 4:
        raise ValueError(f"{name}: truncated TIFF image data")
    px = np.frombuffer(buf[:W * H * 4], np.uint8).reshape(H, W * 4)
    if pred == 3:
        # floating-point predictor: each row's bytes are split into byte
        # planes (most significant first) and differenced along the row
        px = np.cumsum(px, axis=1, dtype=np.uint8).reshape(H, 4, W)
        return np.ascontiguousarray(px.transpose(0, 2, 1)).view(">f4")[..., 0].astype(np.float32)
    return px.view(order + "f4").astype(np.float32).reshape(H, W)


def encode_tiff(img: np.ndarray, rows_per_strip: int = 8) -> bytes:
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.float32:
        raise ValueError(f"unsupported TIFF array: shape {img.shape}, dtype {img.dtype}; "
                         "2-D float32 is supported")
    H, W = img.shape
    pix = np.ascontiguousarray(img, "<f4").tobytes()
    n_strips = -(-H // rows_per_strip)
    strip_bytes = [min(rows_per_strip, H - s * rows_per_strip) * W * 4 for s in range(n_strips)]
    n_tags = 11
    ifd_off = 8
    ifd_size = 2 + 12 * n_tags + 4
    arrays_off = ifd_off + ifd_size
    offs_at, counts_at = arrays_off, arrays_off + 4 * n_strips
    pix_off = counts_at + 4 * n_strips
    offsets = np.cumsum([pix_off] + strip_bytes[:-1]).tolist()

    def entry(tag, typ, cnt, value):
        if typ == 3 and cnt == 1:
            return struct.pack("<HHIHH", tag, typ, cnt, value, 0)
        return struct.pack("<HHII", tag, typ, cnt, value)

    array_tag = lambda tag, vals, at: (entry(tag, 4, 1, vals[0]) if len(vals) == 1
                                       else entry(tag, 4, len(vals), at))
    ifd = struct.pack("<H", n_tags) + b"".join([
        entry(256, 3, 1, W), entry(257, 3, 1, H), entry(258, 3, 1, 32), entry(259, 3, 1, 1),
        entry(262, 3, 1, 1), array_tag(273, offsets, offs_at), entry(277, 3, 1, 1),
        entry(278, 3, 1, rows_per_strip), array_tag(279, strip_bytes, counts_at),
        entry(284, 3, 1, 1), entry(339, 3, 1, 3),
    ]) + struct.pack("<I", 0)
    return (b"II" + struct.pack("<HI", 42, ifd_off) + ifd
            + struct.pack(f"<{n_strips}I", *offsets) + struct.pack(f"<{n_strips}I", *strip_bytes)
            + pix)
