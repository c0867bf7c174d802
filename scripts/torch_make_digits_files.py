#!/usr/bin/env python3
"""Write the UCI hand-written digits in the real-file layouts the drift
datasets read, from ``tests/data/uci_digits.npz`` alone.

The digits are scikit-learn's ``load_digits`` (1,797 human-written 8x8
images, intensities 0..16), stored in the repo as uint8 with their labels.
This script needs numpy and the standard library only (``json``,
``pickle``, ``zlib``, ``struct``), so a host without scikit-learn or PIL
writes the same files that ``scripts/make_digits_leaf.py`` and
``scripts/make_digits_formats.py`` write:

- ``MNIST/train/all_data_digits_train.json``: LEAF train JSON, each digit
  upsampled to 28x28 (4x nearest neighbour, a 2-pixel border cropped) in
  [0, 1], rounded to 4 places;
- ``cifar-10-batches-py/data_batch_{1..5}``: CIFAR python pickles, each
  digit 32x32 (4x nearest neighbour) as uint8 RGB in CHW rows;
- ``cinic10/train/digit_<k>/<index>.png``: an ``ImageFolder`` tree of the
  same 32x32 RGB images, written by a minimal PNG encoder (8-bit RGB, one
  IDAT chunk, filter 0 on every scanline);
- ``FederatedEMNIST/emnist_train.h5`` and ``fed_cifar100/cifar100_train.h5``:
  the TFF flat h5 layouts, only where ``h5py`` imports (else skipped, and
  said so).

Read by the drift datasets' readers, each layout gives bitwise the arrays
that the two scikit-learn scripts' files give. Usage:

    python3 scripts/torch_make_digits_files.py DATA_DIR [--formats
        leaf,cifar,cinic,h5]

It prints one JSON line: the layouts written and those skipped.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import struct
import sys
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGITS = os.path.join(ROOT, "tests", "data", "uci_digits.npz")
FORMATS = ("leaf", "cifar", "cinic", "h5")


def load_digits_npz(path: str = DIGITS) -> tuple[np.ndarray, np.ndarray]:
    """``(images [1797, 8, 8] float64 in [0, 1], labels int64)``, as
    ``load_digits().images / 16.0`` and ``.target``."""
    with np.load(path) as f:
        return f["images"].astype(np.float64) / 16.0, \
            f["target"].astype(np.int64)


def up28(imgs: np.ndarray) -> np.ndarray:
    return np.kron(imgs, np.ones((4, 4)))[:, 2:-2, 2:-2]     # 8x8 -> 28x28


def up32rgb(imgs: np.ndarray) -> np.ndarray:
    up = np.kron(imgs, np.ones((4, 4)))                       # 8x8 -> 32x32
    return np.repeat(up[..., None], 3, axis=3)                # gray -> RGB


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def encode_png_rgb(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of ``img`` ``[H, W, 3]`` uint8: one IDAT chunk,
    every scanline with filter 0."""
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img, np.uint8)
                           .reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write_leaf(data_dir: str, imgs, labels) -> str:
    x = up28(imgs).reshape(len(imgs), 784).round(4)
    out = os.path.join(data_dir, "MNIST", "train")
    os.makedirs(out, exist_ok=True)
    payload = {"users": ["sklearn_digits"], "num_samples": [len(x)],
               "user_data": {"sklearn_digits": {"x": x.tolist(),
                                                "y": labels.tolist()}}}
    path = os.path.join(out, "all_data_digits_train.json")
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def write_cifar(data_dir: str, rgb8, labels) -> str:
    d = os.path.join(data_dir, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    chw = rgb8.transpose(0, 3, 1, 2).reshape(len(rgb8), 3072)
    for i, idx in enumerate(np.array_split(np.arange(len(rgb8)), 5), 1):
        with open(os.path.join(d, f"data_batch_{i}"), "wb") as f:
            pickle.dump({b"data": chw[idx],
                         b"labels": labels[idx].tolist()}, f)
    return d


def write_cinic(data_dir: str, rgb8, labels) -> str:
    root = os.path.join(data_dir, "cinic10", "train")
    for k in range(10):
        d = os.path.join(root, f"digit_{k}")
        os.makedirs(d, exist_ok=True)
        for j in np.flatnonzero(labels == k):
            with open(os.path.join(d, f"{j:05d}.png"), "wb") as f:
                f.write(encode_png_rgb(rgb8[j]))
    return root


def write_h5(data_dir: str, imgs, rgb8, labels) -> list[str]:
    import h5py
    out = []
    for sub, name, key, pixels in (
            ("FederatedEMNIST", "emnist_train.h5", "pixels",
             up28(imgs).astype(np.float32)),
            ("fed_cifar100", "cifar100_train.h5", "image", rgb8)):
        d = os.path.join(data_dir, sub)
        os.makedirs(d, exist_ok=True)
        out.append(os.path.join(d, name))
        with h5py.File(out[-1], "w") as f:
            f.create_dataset(key, data=pixels)
            f.create_dataset("label", data=labels)
            f.create_dataset("id", data=np.arange(len(labels)) % 50)
    return out


def write_all(data_dir: str, formats=FORMATS) -> dict:
    """Write ``formats`` under ``data_dir``; returns what was written and
    what was skipped (the h5 files without h5py)."""
    imgs, labels = load_digits_npz()
    rgb8 = (up32rgb(imgs) * 255).astype(np.uint8)
    written, skipped = {}, {}
    if "leaf" in formats:
        written["leaf"] = write_leaf(data_dir, imgs, labels)
    if "cifar" in formats:
        written["cifar"] = write_cifar(data_dir, rgb8, labels)
    if "cinic" in formats:
        written["cinic"] = write_cinic(data_dir, rgb8, labels)
    if "h5" in formats:
        try:
            import h5py  # noqa: F401
        except ImportError:
            skipped["h5"] = "h5py is not installed"
        else:
            written["h5"] = write_h5(data_dir, imgs, rgb8, labels)
    return {"written": written, "skipped": skipped, "digits": len(labels)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("data_dir")
    ap.add_argument("--formats", default=",".join(FORMATS))
    args = ap.parse_args()
    formats = args.formats.split(",")
    unknown = set(formats) - set(FORMATS)
    if unknown:
        ap.error(f"unknown formats {sorted(unknown)}; known: {FORMATS}")
    print(json.dumps(write_all(args.data_dir, formats)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
