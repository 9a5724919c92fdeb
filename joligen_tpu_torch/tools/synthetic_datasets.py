"""Synthetic datasets in the on-disk layouts of the palette example configs,
made from a seed: the online bbox-crop layout (``xview``, ``mapillary``,
``mario``), ``single`` (``df2kost``) and ``aligned`` (``SEN2VEN``). Paths
in ``paths.txt`` are relative to the root (``data_relative_paths``).

    python -m joligen_tpu_torch.tools.synthetic_datasets online DIR [N [SIZE]]
"""

from __future__ import annotations

import os
import sys

import numpy as np
from PIL import Image


def _image(rng, size):
    """A smooth colour gradient with noise, so that crops and edges differ
    from image to image."""
    yy, xx = np.mgrid[0:size, 0:size]
    base = np.stack([xx, yy, (xx + yy) // 2], -1) * (255.0 / size)
    base = base + rng.integers(0, 96, 3)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(
        np.uint8)


def write_online(root, n, size, seed=0, domains=("A",), classes=(1, 2)):
    """``train{domain}/imgs/*.png`` of ``size``² px with
    ``train{domain}/bbox/*.txt`` files of 1 to 3 boxes drawn from
    ``classes`` (lines 'cls x1 y1 x2 y2', each box a flat patch in the
    image), and ``train{domain}/paths.txt`` lines 'img bbox'."""
    rng = np.random.default_rng(seed)
    for dom in domains:
        base = os.path.join(root, f"train{dom}")
        os.makedirs(os.path.join(base, "imgs"), exist_ok=True)
        os.makedirs(os.path.join(base, "bbox"), exist_ok=True)
        lines = []
        for i in range(n):
            img = _image(rng, size)
            boxes = []
            for _ in range(rng.integers(1, 4)):
                w, h = rng.integers(size // 10, size // 4, 2)
                x1 = int(rng.integers(0, size - w))
                y1 = int(rng.integers(0, size - h))
                img[y1:y1 + h, x1:x1 + w] = rng.integers(0, 256, 3)
                boxes.append(f"{rng.choice(classes)} {x1} {y1} {x1 + w} "
                             f"{y1 + h}")
            ipath = f"train{dom}/imgs/{i:04d}.png"
            bpath = f"train{dom}/bbox/{i:04d}.txt"
            Image.fromarray(img).save(os.path.join(root, ipath))
            with open(os.path.join(root, bpath), "w") as f:
                f.write("\n".join(boxes) + "\n")
            lines.append(f"{ipath} {bpath}")
        with open(os.path.join(base, "paths.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def write_single(root, n, size, seed=0):
    """``trainA/*.png``: one domain of ``size``² px images."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "trainA"), exist_ok=True)
    for i in range(n):
        Image.fromarray(_image(rng, size)).save(
            os.path.join(root, "trainA", f"{i:04d}.png"))


def write_aligned(root, n, size, seed=0):
    """``trainA/*.png`` and ``trainB/*.png`` pairs of the same name: B is A
    with its channels reversed and brightened, a pixel-aligned pair."""
    rng = np.random.default_rng(seed)
    for dom in "AB":
        os.makedirs(os.path.join(root, f"train{dom}"), exist_ok=True)
    for i in range(n):
        a = _image(rng, size)
        b = np.clip(a[..., ::-1].astype(np.int16) + 40, 0, 255).astype(
            np.uint8)
        Image.fromarray(a).save(os.path.join(root, "trainA", f"{i:04d}.png"))
        Image.fromarray(b).save(os.path.join(root, "trainB", f"{i:04d}.png"))


WRITERS = {"online": write_online, "single": write_single,
           "aligned": write_aligned}


if __name__ == "__main__":
    kind, root = sys.argv[1], sys.argv[2]
    n = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    size = int(sys.argv[4]) if len(sys.argv) > 4 else 320
    WRITERS[kind](root, n, size)
    print(f"{kind} dataset at {root}: {n} images of {size} px")
