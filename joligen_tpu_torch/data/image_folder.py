"""Image directory / paths.txt listing: a copy of
``joligen_tpu/data/image_folder.py`` (reference data/image_folder.py)."""

from __future__ import annotations

import os

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".tif", ".tiff",
                  ".webp", ".JPG", ".JPEG", ".PNG")


def is_image_file(fn):
    return fn.lower().endswith(tuple(e.lower() for e in IMG_EXTENSIONS))


def make_dataset(d, max_dataset_size=float("inf")):
    assert os.path.isdir(d), f"{d} is not a valid directory"
    images = []
    for root, _, fnames in sorted(os.walk(d)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(root, fname))
    return images[: min(int(max_dataset_size), len(images))]


def make_labeled_path_dataset(d, paths, max_dataset_size=float("inf")):
    """Parse ``<dir>/<paths>`` lines 'img [label...]'
    (reference data/image_folder.py:81-104)."""
    images, labels = [], []
    assert os.path.isdir(d), f"{d} is not a valid directory"
    with open(d + paths) as f:
        lines = f.read().split("\n")
    for line in lines:
        parts = line.split(" ")
        if len(parts) == 1 and parts[0]:
            images.append(parts[0])
        elif len(parts) >= 2:
            images.append(parts[0])
            labels.append(" ".join(parts[1:]))
    if max_dataset_size in (None, float("inf")):
        return images, labels
    n = min(int(max_dataset_size), len(images))
    return images[:n], labels[:n]


def make_ref_path(d, paths):
    """img path -> its single reference path, from ``<d><paths>`` lines
    '<img> <ref>' (reference data/image_folder.py:123-136)."""
    ref = {}
    assert os.path.isdir(d), f"{d} is not a valid directory"
    with open(d + paths) as f:
        for line in f.read().split("\n"):
            parts = line.split(" ")
            if len(parts) == 2:
                ref[parts[0]] = parts[1]
    return ref
