"""Label mirroring (the counterpart of ``detection/mirror.py``): each image
flipped (``h``, ``v``, or ``hv``: a 180 degree turn) into a new image
directory and its normalised polygon labels flipped (1 - x, 1 - y) into a
new label directory.

The JAX package re-encodes through PIL. Here a JPEG is decoded by
``utils/jpeg.py`` and written back by ``encode_jpeg`` at PIL's defaults
(quality 75, 4:2:0 chroma, standard Huffman tables), and a PNG by
``utils/image.write_image``: the decoded pixels are PIL's; the files'
bytes differ in their headers (JFIF density and PNG compression). Like
every entry point of the port it starts only on a machine with a card
unless ``--device cpu`` is given (the flips run on the host).

    python -m poseestimator_tpu_torch.apps.mirror --image-dir I --label-dir L \\
        --out-image-dir I2 --out-label-dir L2 [--flip hv] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..device import resolve_device

PIL_JPEG_QUALITY = 75  # PIL's default when saving a JPEG


def flip_coords(coords, flip_type):
    """(x, y, x, y, ...) normalised -> flipped."""
    out = []
    for i, val in enumerate(coords):
        if i % 2 == 0:  # x
            out.append(1 - val if flip_type in ("h", "hv") else val)
        else:  # y
            out.append(1 - val if flip_type in ("v", "hv") else val)
    return out


def flip_image(img: np.ndarray, flip_type: str) -> np.ndarray:
    if flip_type in ("h", "hv"):
        img = img[:, ::-1]
    if flip_type in ("v", "hv"):
        img = img[::-1]
    return np.ascontiguousarray(img)


def mirror_dataset(image_dir, label_dir, out_image_dir, out_label_dir, flip_type="hv") -> int:
    from ..utils.image import IMREAD_UNCHANGED, read_image, write_image
    from ..utils.jpeg import encode_jpeg

    os.makedirs(out_image_dir, exist_ok=True)
    os.makedirs(out_label_dir, exist_ok=True)
    n = 0
    for filename in sorted(os.listdir(image_dir)):
        if not filename.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        stem = os.path.splitext(filename)[0]
        label_path = os.path.join(label_dir, stem + ".txt")
        if not os.path.exists(label_path):
            print(f"Warning: No label for {filename}")
            continue
        img = flip_image(read_image(os.path.join(image_dir, filename), IMREAD_UNCHANGED),
                         flip_type)
        out = os.path.join(out_image_dir, filename)
        if filename.lower().endswith((".jpg", ".jpeg")):
            with open(out, "wb") as f:
                f.write(encode_jpeg(img, quality=PIL_JPEG_QUALITY))
        else:
            write_image(out, img)
        lines_out = []
        with open(label_path) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                coords = flip_coords([float(v) for v in parts[1:]], flip_type)
                lines_out.append(parts[0] + " " + " ".join(f"{c:.6f}" for c in coords))
        with open(os.path.join(out_label_dir, stem + ".txt"), "w") as f:
            f.write("\n".join(lines_out))
        n += 1
    return n


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image-dir", required=True)
    p.add_argument("--label-dir", required=True)
    p.add_argument("--out-image-dir", required=True)
    p.add_argument("--out-label-dir", required=True)
    p.add_argument("--flip", default="hv", choices=["h", "v", "hv"])
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    n = mirror_dataset(args.image_dir, args.label_dir, args.out_image_dir, args.out_label_dir,
                       args.flip)
    print(f"mirrored {n} samples")
    return 0


if __name__ == "__main__":
    sys.exit(main())
