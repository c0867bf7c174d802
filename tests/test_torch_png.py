"""The port's PNG decoder (``feddrift_torch/data/png.py``) against the JAX
package's (``feddrift_tpu/data/png.py``) on the CPU: the same bytes give
bitwise the same array, and a file the reference refuses is refused with
the same exception type and message. The cases are those of
``tests/test_png.py`` (PIL's modes, hand-filtered scanlines of every
filter type, a palette, the rejections) with PIL as an independent
oracle, plus the minimal encoder of ``scripts/torch_make_digits_files.py``
that writes the cinic10 tree the card reads."""

import importlib.util
import io
import os
import struct
import zlib

import numpy as np
import pytest

from feddrift_torch.data import png as tpng
from feddrift_tpu.data import png as jpng
from torch_threads import one_intra_op_thread  # noqa: F401

PIL = pytest.importorskip("PIL.Image")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digits_script():
    spec = importlib.util.spec_from_file_location(
        "torch_make_digits_files",
        os.path.join(REPO, "scripts", "torch_make_digits_files.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pil_bytes(arr: np.ndarray, mode: str) -> bytes:
    buf = io.BytesIO()
    PIL.fromarray(arr, mode=mode).save(buf, format="PNG")
    return buf.getvalue()


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def _raw_png(height, width, color_type, scanlines: bytes,
             palette: bytes | None = None, depth: int = 8) -> bytes:
    ihdr = struct.pack(">IIBBBBB", width, height, depth, color_type, 0, 0, 0)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
    if palette is not None:
        out += _chunk(b"PLTE", palette)
    return out + _chunk(b"IDAT", zlib.compress(scanlines)) \
        + _chunk(b"IEND", b"")


def _same(data: bytes):
    """Both decoders on ``data``: bitwise the same array (and the same
    normalised RGB array), returned."""
    got, want = tpng.decode_png(data), jpng.decode_png(data)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape and np.array_equal(got, want)
    rgb, want_rgb = tpng.decode_png_rgb(data), jpng.decode_png_rgb(data)
    assert rgb.shape == want_rgb.shape and np.array_equal(rgb, want_rgb)
    return got


@pytest.mark.parametrize("mode,shape", [
    ("RGB", (32, 32, 3)), ("RGBA", (32, 32, 4)), ("L", (32, 32)),
    ("RGB", (7, 5, 3)), ("LA", (9, 6, 2))])
def test_pil_modes_match_reference(mode, shape):
    rng = np.random.default_rng(sum(map(ord, mode)) + shape[0])
    arr = rng.integers(0, 256, shape).astype(np.uint8)
    assert np.array_equal(_same(_pil_bytes(arr, mode)), arr)


def test_gradient_image_matches_reference():
    """Smooth gradients push PIL's adaptive filter choice to Sub, Up,
    Average and Paeth."""
    g = np.arange(64 * 64 * 3, dtype=np.int64).reshape(64, 64, 3)
    arr = (g % 251).astype(np.uint8)
    assert np.array_equal(_same(_pil_bytes(arr, "RGB")), arr)


def test_rgb_normalisation_matches_reference():
    rng = np.random.default_rng(3)
    gray = rng.integers(0, 256, (8, 8)).astype(np.uint8)
    out = tpng.decode_png_rgb(_pil_bytes(gray, "L"))
    assert out.shape == (8, 8, 3) and np.array_equal(out[..., 1], gray)
    rgba = rng.integers(0, 256, (8, 8, 4)).astype(np.uint8)
    _same(_pil_bytes(rgba, "RGBA"))
    assert np.array_equal(tpng.decode_png_rgb(_pil_bytes(rgba, "RGBA")),
                          rgba[..., :3])


def _filtered(img, ftype, bpp):
    """Scanlines of ``img`` ``[h, w * bpp]`` under filter ``ftype``."""
    rows, prev = [], np.zeros(img.shape[1], np.int64)
    for cur in img:
        line = np.zeros_like(cur)
        for i in range(len(cur)):
            a = cur[i - bpp] if i >= bpp else 0
            b, c = prev[i], (prev[i - bpp] if i >= bpp else 0)
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            line[i] = (cur[i] - pred) % 256
        rows.append(bytes([ftype]) + bytes(line.astype(np.uint8)))
        prev = cur
    return b"".join(rows)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_filter_type_matches_reference(ftype):
    rng = np.random.default_rng(40 + ftype)
    h, w, bpp = 6, 4, 3
    img = rng.integers(0, 256, (h, w * bpp)).astype(np.int64)
    data = _raw_png(h, w, 2, _filtered(img, ftype, bpp))
    expect = img.reshape(h, w, bpp).astype(np.uint8)
    assert np.array_equal(_same(data), expect)
    assert np.array_equal(np.asarray(PIL.open(io.BytesIO(data))
                                     .convert("RGB")), expect)


def test_mixed_filters_match_reference():
    """A different filter on every scanline, each row predicted from the
    one before it, as an adaptive encoder writes them."""
    rng = np.random.default_rng(7)
    h, w, bpp = 10, 5, 4
    img = rng.integers(0, 256, (h, w * bpp)).astype(np.int64)
    # row r's line under filter r % 5 (the last line _filtered writes)
    data = b"".join(bytes([r % 5]) + _filtered(img[:r + 1], r % 5, bpp)
                    [-(w * bpp):] for r in range(h))
    assert np.array_equal(_same(_raw_png(h, w, 6, data)),
                          img.reshape(h, w, bpp).astype(np.uint8))


def test_palette_matches_reference():
    pal = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [7, 8, 9]],
                   np.uint8)
    idx = np.array([[0, 1], [2, 3]], np.uint8)
    rows = b"".join(bytes([0]) + bytes(r) for r in idx)
    data = _raw_png(2, 2, 3, rows, palette=pal.tobytes())
    assert np.array_equal(_same(data), pal[idx])
    assert np.array_equal(np.asarray(PIL.open(io.BytesIO(data))
                                     .convert("RGB")), pal[idx])


def _refusals():
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 0)
    head = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
    good = _pil_bytes(np.zeros((4, 4, 3), np.uint8), "RGB")
    return {
        "not_png": b"JFIF not a png",
        "truncated_pixels": head + _chunk(b"IDAT", zlib.compress(
            b"\x00" * 10)) + _chunk(b"IEND", b""),
        "bit_depth_16": _raw_png(4, 4, 0, b"\x00" * (4 * 9), depth=16),
        "truncated_chunk": good[:40],
        "missing_ihdr": b"\x89PNG\r\n\x1a\n" + _chunk(b"IEND", b""),
        "missing_idat": head + _chunk(b"IEND", b""),
        "color_type_5": _raw_png(1, 1, 5, b"\x00\x00"),
        "interlaced": b"\x89PNG\r\n\x1a\n" + _chunk(
            b"IHDR", struct.pack(">IIBBBBB", 1, 1, 8, 0, 0, 0, 1))
        + _chunk(b"IDAT", zlib.compress(b"\x00\x00")) + _chunk(b"IEND", b""),
        "palette_without_plte": _raw_png(1, 1, 3, b"\x00\x00"),
        "unknown_filter": _raw_png(1, 1, 0, b"\x07\x00"),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_refusals_match_reference(case):
    """A file the reference refuses is refused with the same exception
    type and message: not a PNG, truncated pixels, 16 bits a sample, and
    the rest of the decoder's checks."""
    data = _refusals()[case]
    with pytest.raises(Exception) as want:
        jpng.decode_png(data)
    with pytest.raises(Exception) as got:
        tpng.decode_png(data)
    assert type(got.value) is type(want.value) is ValueError
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape", [(32, 32, 3), (3, 7, 3)])
def test_digits_encoder_round_trips(shape):
    """``encode_png_rgb`` writes what PIL and both decoders read back as
    the source image."""
    enc = _digits_script().encode_png_rgb
    arr = np.random.default_rng(shape[1]).integers(0, 256, shape) \
        .astype(np.uint8)
    data = enc(arr)
    assert np.array_equal(_same(data), arr)
    assert np.array_equal(np.asarray(PIL.open(io.BytesIO(data))), arr)
