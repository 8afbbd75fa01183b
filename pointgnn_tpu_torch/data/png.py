"""PNG reading and writing on ``zlib`` and numpy (no OpenCV, no PIL).

The port reads KITTI images with :func:`read_png`, which returns BGR as
``cv2.imread`` does, and writes synthetic ones with :func:`write_png`,
which takes BGR as ``cv2.imwrite`` does.

The reader takes non-interlaced 8-bit RGB and RGBA images (alpha is
dropped, as ``cv2.imread`` does by default): it walks the chunks, checks
their CRCs, joins the ``IDAT`` data, inflates it and undoes the five row
filters in the port's host C++ library (``csrc/host/png.cpp``, built at
first use by :mod:`postprocess.native`): the Average and Paeth filters
predict each byte from the decoded byte to its left, a byte-by-byte
loop too slow in Python.  Any other PNG (palette,
grayscale, 16-bit, interlaced) raises.  The writer emits one filter
type on every row (None by default; the others, which photographs'
encoders pick, serve the tests and timings) in one ``IDAT`` chunk.
"""

import struct
import zlib

import numpy as np

from pointgnn_tpu_torch.postprocess import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # color type -> bytes per pixel at 8 bits


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> ``[H, W, 3]`` uint8 BGR."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG chunk header")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG chunk %r" % kind)
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError("PNG chunk %r fails its CRC" % kind)
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    width, height, depth, color, compression, filtering, interlace = header
    if depth != 8 or color not in _CHANNELS:
        raise ValueError(
            "unsupported PNG: bit depth %d, color type %d (only 8-bit RGB "
            "and RGBA are read)" % (depth, color))
    if interlace != 0:
        raise ValueError("unsupported PNG: interlaced (Adam7)")
    if compression != 0 or filtering != 0:
        raise ValueError("unsupported PNG: compression %d, filter method %d"
                         % (compression, filtering))
    bpp = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (1 + width * bpp):
        raise ValueError("PNG data holds %d bytes, %dx%d needs %d"
                         % (raw.size, width, height,
                            height * (1 + width * bpp)))
    pixels = native.png_unfilter(raw.reshape(height, 1 + width * bpp), bpp)
    rgb = pixels.reshape(height, width, bpp)[:, :, :3]
    return np.ascontiguousarray(rgb[:, :, ::-1])


def read_png(path: str) -> np.ndarray:
    """Read a PNG file as ``[H, W, 3]`` uint8 BGR."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def _filter(raw: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    """Filter every row of the image bytes ``raw`` [H, stride] with
    filter ``kind``; returns [H, 1 + stride] with the filter bytes."""
    cur = raw.astype(np.int16)
    left = np.zeros_like(cur)
    left[:, bpp:] = cur[:, :-bpp]
    up = np.zeros_like(cur)
    up[1:] = cur[:-1]
    upleft = np.zeros_like(cur)
    upleft[1:, bpp:] = cur[:-1, :-bpp]
    if kind == 0:
        pred = np.zeros_like(cur)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) >> 1
    elif kind == 4:
        p = left + up - upleft
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, upleft))
    else:
        raise ValueError("PNG filter type %r is not one of 0-4" % (kind,))
    rows = np.empty((raw.shape[0], 1 + raw.shape[1]), np.uint8)
    rows[:, 0] = kind
    rows[:, 1:] = (cur - pred).astype(np.uint8)  # mod 256
    return rows


def encode_png(image_bgr: np.ndarray, filter_type: int = 0) -> bytes:
    """``[H, W, 3]`` uint8 BGR -> PNG bytes (8-bit RGB, ``filter_type``
    on every row)."""
    image = np.asarray(image_bgr)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError("write_png takes [H, W, 3] uint8, got %s %s"
                         % (image.dtype, image.shape))
    height, width = image.shape[:2]
    rows = _filter(image[:, :, ::-1].reshape(height, -1), filter_type, 3)
    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str, image_bgr: np.ndarray) -> None:
    """Write ``[H, W, 3]`` uint8 BGR as a PNG file."""
    data = encode_png(image_bgr)
    with open(path, "wb") as f:
        f.write(data)
