"""Sample grids and reconstruction panels — port of
``movae_tpu/train/figures.py``.

The same files at the same names: a PDF under
``<save_root>/figures/{generated,reconstructed}/`` and a PNG twin beside
it. The JAX package draws them with matplotlib; the port writes the
images itself (a PNG through ``zlib``/``struct`` and a one-image PDF), so
it needs no plotting package on the card: the panels carry the images
without titles.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Optional

import numpy as np

# white border between cells, and the smallest cell side in pixels
# (smaller images are repeated up by an integer factor)
PAD, MIN_CELL = 2, 128


def _to_display(img: np.ndarray, normalized: bool) -> np.ndarray:
    """Model-range image -> [0, 1] (denormalized from [-1, 1] when the
    inputs were normalized or the values show it)."""
    img = np.asarray(img, np.float32)
    if normalized or img.min() < -0.01:
        img = img * 0.5 + 0.5
    return np.clip(img, 0.0, 1.0)


def _canvas(rows, normalized: bool) -> np.ndarray:
    """Tile a list of rows of NHWC images into one uint8 RGB canvas."""
    size = max(im.shape[0] for row in rows for im in row)
    scale = max(1, MIN_CELL // size)
    cell = size * scale + PAD
    ncols = max(len(row) for row in rows)
    out = np.full((len(rows) * cell + PAD, ncols * cell + PAD, 3), 255,
                  np.uint8)
    for r, row in enumerate(rows):
        for c, im in enumerate(row):
            im = _to_display(im, normalized)
            if im.shape[-1] == 1:
                im = np.repeat(im, 3, axis=-1)
            im = np.repeat(np.repeat(im, scale, 0), scale, 1)
            y, x = PAD + r * cell, PAD + c * cell
            out[y:y + im.shape[0], x:x + im.shape[1]] = np.round(
                im * 255.0).astype(np.uint8)
    return out


def _png_bytes(rgb: np.ndarray) -> bytes:
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _pdf_bytes(rgb: np.ndarray) -> bytes:
    """A one-page PDF holding ``rgb`` at one point per pixel."""
    h, w, _ = rgb.shape
    image = zlib.compress(np.ascontiguousarray(rgb).tobytes(), 6)
    draw = f"q {w} 0 0 {h} 0 0 cm /Im0 Do Q".encode()
    objects = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        (f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {w} {h}] "
         f"/Resources << /XObject << /Im0 4 0 R >> >> /Contents 5 0 R >>"
         ).encode(),
        (f"<< /Type /XObject /Subtype /Image /Width {w} /Height {h} "
         f"/ColorSpace /DeviceRGB /BitsPerComponent 8 /Filter /FlateDecode "
         f"/Length {len(image)} >>\nstream\n").encode()
        + image + b"\nendstream",
        f"<< /Length {len(draw)} >>\nstream\n".encode() + draw
        + b"\nendstream",
    ]
    out = bytearray(b"%PDF-1.4\n")
    offsets = []
    for i, body in enumerate(objects, 1):
        offsets.append(len(out))
        out += f"{i} 0 obj\n".encode() + body + b"\nendobj\n"
    xref = len(out)
    out += f"xref\n0 {len(objects) + 1}\n0000000000 65535 f \n".encode()
    for off in offsets:
        out += f"{off:010d} 00000 n \n".encode()
    out += (f"trailer\n<< /Size {len(objects) + 1} /Root 1 0 R >>\n"
            f"startxref\n{xref}\n%%EOF\n").encode()
    return bytes(out)


def _save(canvas: np.ndarray, path: str) -> str:
    """Write the PDF at ``path`` and its PNG twin; returns the PNG path."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_pdf_bytes(canvas))
    png = os.path.splitext(path)[0] + ".png"
    with open(png, "wb") as f:
        f.write(_png_bytes(canvas))
    return png


def save_sample_grid(images: np.ndarray, path: str, normalized: bool = False,
                     ncols: Optional[int] = None) -> str:
    """An NHWC image grid as a PDF (+ PNG twin); returns the PNG path."""
    images = np.asarray(images)
    n = len(images)
    ncols = ncols or int(math.ceil(math.sqrt(n)))
    rows = [list(images[i:i + ncols]) for i in range(0, n, ncols)]
    return _save(_canvas(rows, normalized), path)


def save_reconstruction_panel(originals: np.ndarray, recons: np.ndarray,
                              path: str, normalized: bool = False) -> str:
    """Two rows: originals on top, reconstructions below."""
    return _save(_canvas([list(np.asarray(originals)),
                          list(np.asarray(recons))], normalized), path)
