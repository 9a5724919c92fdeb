"""Synthetic datasets in the on-disk layouts of the diffusion example
configs, made from a seed: ``labeled`` (``self_supervised_labeled_mask``:
``noglasses2glasses``, ``viton_tutorial``, the cm configs), the online
bbox-crop layout (``xview``, ``mapillary``, ``mario``), ``single``
(``df2kost``), ``aligned`` (``SEN2VEN``) and ``online_ref`` (the online
layout with a reference image per image: ``unetref_viton``); and of the GAN
example configs: ``unaligned`` (``horse2zebra``, ``mnist2USPS``),
``unaligned_labeled`` (``unaligned_labeled_mask``: the glasses configs),
``unaligned_labeled_cls`` and ``unaligned_labeled_mask_cls`` (class labels,
a tint each, without and with masks: the classifier's layouts) and
``online_ab`` (online bbox crops in both domains, classes 1 to 6:
``mario2sonic``); and ``video`` (``self_supervised_vid_mask_online``:
series of frames with a box file each, the ``vid_mario`` configs).
Paths in ``paths.txt`` are relative to the root (``data_relative_paths``).
``write_test_split`` adds a layout's ``test*`` split (the train-time
metrics' test sets).

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


def write_labeled(root, n, size, seed=0):
    """``trainA/imgs/*.png`` of ``size``² px, ``trainA/masks/*.png`` (a
    rectangle of label 1 on 0) and ``trainA/paths.txt`` lines
    'img 0 mask'."""
    rng = np.random.default_rng(seed)
    for sub in ("imgs", "masks"):
        os.makedirs(os.path.join(root, "trainA", sub), exist_ok=True)
    lines = []
    for i in range(n):
        mask = np.zeros((size, size), np.uint8)
        x0, y0 = rng.integers(size // 16, size // 2, 2)
        w, h = rng.integers(size // 6, size // 3 + 1, 2)
        mask[y0:y0 + h, x0:x0 + w] = 1
        ipath = f"trainA/imgs/{i:04d}.png"
        mpath = f"trainA/masks/{i:04d}.png"
        Image.fromarray(_image(rng, size)).save(os.path.join(root, ipath))
        Image.fromarray(mask).save(os.path.join(root, mpath))
        lines.append(f"{ipath} 0 {mpath}")
    with open(os.path.join(root, "trainA", "paths.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


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


def write_unaligned(root, n, size, seed=0):
    """``trainA/*.png`` and ``trainB/*.png``, ``n`` unrelated images each;
    B's are striped, a domain A's do not show."""
    rng = np.random.default_rng(seed)
    for dom in "AB":
        os.makedirs(os.path.join(root, f"train{dom}"), exist_ok=True)
    stripes = ((np.arange(size) // max(1, size // 16)) % 2 * 90)[None, :,
                                                                 None]
    for i in range(n):
        Image.fromarray(_image(rng, size)).save(
            os.path.join(root, "trainA", f"{i:04d}.png"))
        b = np.clip(_image(rng, size).astype(np.int16) + stripes - 45, 0,
                    255).astype(np.uint8)
        Image.fromarray(b).save(os.path.join(root, "trainB", f"{i:04d}.png"))


def _rect_mask(rng, size):
    """A rectangle of label 1 on 0."""
    mask = np.zeros((size, size), np.uint8)
    x0, y0 = rng.integers(size // 16, size // 2, 2)
    w, h = rng.integers(size // 6, size // 3 + 1, 2)
    mask[y0:y0 + h, x0:x0 + w] = 1
    return mask


def write_unaligned_labeled(root, n, size, seed=0):
    """``trainA`` and ``trainB`` in the ``unaligned_labeled_mask`` layout,
    ``n`` images of ``size``² px each: ``imgs/*.png``, ``masks/*.png`` (a
    rectangle of label 1 on 0) and ``paths.txt`` lines 'img mask'. B's
    images carry a dark band inside their masks (the object A lacks)."""
    rng = np.random.default_rng(seed)
    for dom in "AB":
        base = os.path.join(root, f"train{dom}")
        for sub in ("imgs", "masks"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        lines = []
        for i in range(n):
            img, mask = _image(rng, size), _rect_mask(rng, size)
            if dom == "B":
                img[mask > 0] = img[mask > 0] // 4
            ipath = f"train{dom}/imgs/{i:04d}.png"
            mpath = f"train{dom}/masks/{i:04d}.png"
            Image.fromarray(img).save(os.path.join(root, ipath))
            Image.fromarray(mask).save(os.path.join(root, mpath))
            lines.append(f"{ipath} {mpath}")
        with open(os.path.join(base, "paths.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def write_unaligned_labeled_cls(root, n, size, seed=0, with_mask=False,
                                nclasses=2):
    """``trainA`` and ``trainB`` of ``n`` images of ``size``² px each with a
    class label drawn from ``nclasses``, each class tinting its images its
    own way (a classifier can learn it): ``imgs/*.png`` and ``paths.txt``
    lines 'img cls' (``unaligned_labeled_cls``), or with ``with_mask`` also
    ``masks/*.png`` (a rectangle of label 1 on 0, B's images darkened
    inside it as in ``write_unaligned_labeled``) and lines 'img cls mask'
    (``unaligned_labeled_mask_cls``)."""
    rng = np.random.default_rng(seed)
    tints = [np.roll(np.array([72, -36, -36]), c) * (1 + c // 3)
             for c in range(nclasses)]
    for dom in "AB":
        base = os.path.join(root, f"train{dom}")
        for sub in ("imgs", "masks") if with_mask else ("imgs",):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        lines = []
        for i in range(n):
            cls = int(rng.integers(0, nclasses))
            img = np.clip(_image(rng, size).astype(np.int16) + tints[cls],
                          0, 255).astype(np.uint8)
            ipath = f"train{dom}/imgs/{i:04d}.png"
            line = f"{ipath} {cls}"
            if with_mask:
                mask = _rect_mask(rng, size)
                if dom == "B":
                    img[mask > 0] = img[mask > 0] // 4
                mpath = f"train{dom}/masks/{i:04d}.png"
                Image.fromarray(mask).save(os.path.join(root, mpath))
                line += f" {mpath}"
            Image.fromarray(img).save(os.path.join(root, ipath))
            lines.append(line)
        with open(os.path.join(base, "paths.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def write_unaligned_labeled_mask_cls(root, n, size, seed=0, nclasses=2):
    """``write_unaligned_labeled_cls`` with the masks."""
    write_unaligned_labeled_cls(root, n, size, seed, True, nclasses)


def write_online_ab(root, n, size, seed=0):
    """The online layout (``write_online``) in ``trainA`` and ``trainB``,
    boxes of classes 1 to 6 (mario2sonic's 7 f_s classes with 0)."""
    write_online(root, n, size, seed, domains=("A", "B"),
                 classes=tuple(range(1, 7)))


def write_refs(root, n, seed=0, ref_size=96):
    """A reference image for each of ``trainA/imgs/0000.png``...: the
    ``trainA/ref/*.png`` of ``ref_size``² px and ``trainA/conditions.txt``
    lines '<img> <ref>' (the ``*_ref`` modes)."""
    rng = np.random.default_rng(seed + 1)
    os.makedirs(os.path.join(root, "trainA", "ref"), exist_ok=True)
    lines = []
    for i in range(n):
        rpath = f"trainA/ref/{i:04d}.png"
        Image.fromarray(_image(rng, ref_size)[::-1]).save(
            os.path.join(root, rpath))
        lines.append(f"trainA/imgs/{i:04d}.png {rpath}")
    with open(os.path.join(root, "trainA", "conditions.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def write_online_ref(root, n, size, seed=0):
    """The online layout of ``trainA`` (``write_online``) with a reference
    image for each image (``write_refs``)."""
    write_online(root, n, size, seed)
    write_refs(root, n, seed)


def write_video(root, n, size, seed=0, n_series=2, domains=("A",),
                phases=("train", "test")):
    """The video layout, as ``tools/make_fake_dataset.py``'s ``make_video``
    writes it: in ``{phase}{domain}`` (``train`` and ``test``, or
    ``phases``), ``n_series`` directories ``vid{s}`` of ``n`` noise frames
    ``frame_{i:03d}.png`` of ``size``² px (zlib level 1: noise does not
    compress), each with a box file ``frame_{i:03d}.txt`` ('1 x1 y1 x2 y2')
    around a flat square that moves a few pixels a frame, and ``paths.txt``
    lines 'img bbox'."""
    rng = np.random.RandomState(seed)
    for dom in domains:
        for phase in phases:
            base = f"{phase}{dom}"
            lines = []
            for s in range(n_series):
                os.makedirs(os.path.join(root, base, f"vid{s}"),
                            exist_ok=True)
                x1, y1 = rng.randint(4, size // 3, 2)
                w = rng.randint(size // 8, size // 4)
                vx, vy = rng.randint(1, 4, 2)
                for i in range(n):
                    img = (rng.rand(size, size, 3) * 255).astype(np.uint8)
                    xa = int(np.clip(x1 + i * vx, 0, size - w - 1))
                    ya = int(np.clip(y1 + i * vy, 0, size - w - 1))
                    img[ya:ya + w, xa:xa + w] = rng.randint(0, 255, 3)
                    ipath = os.path.join(base, f"vid{s}", f"frame_{i:03d}.png")
                    Image.fromarray(img).save(os.path.join(root, ipath),
                                              compress_level=1)
                    bpath = os.path.join(base, f"vid{s}", f"frame_{i:03d}.txt")
                    with open(os.path.join(root, bpath), "w") as f:
                        f.write(f"1 {xa} {ya} {xa + w} {ya + w}\n")
                    lines.append(f"{ipath} {bpath}")
            with open(os.path.join(root, base, "paths.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")


def write_test_split(kind, root, n, size, seed=1, **kw):
    """The ``kind`` layout's test split in ``root``: what ``WRITERS[kind]``
    writes as ``train*`` (``n`` images from ``seed``), moved to ``test*``,
    the paths in its list files renamed alike. (The video layout writes
    its test split itself.)"""
    tmp = os.path.join(root, "_test_split")
    WRITERS[kind](tmp, n, size, seed=seed, **kw)
    for d in sorted(os.listdir(tmp)):
        dst = os.path.join(root, "test" + d[len("train"):])
        os.rename(os.path.join(tmp, d), dst)
        for fname in ("paths.txt", "conditions.txt"):
            path = os.path.join(dst, fname)
            if os.path.exists(path):
                with open(path) as f:
                    text = f.read()
                with open(path, "w") as f:
                    f.write(text.replace(d + "/", "test" + d[len("train"):]
                                         + "/"))
    os.rmdir(tmp)


WRITERS = {"labeled": write_labeled, "online": write_online, "single": write_single,
           "aligned": write_aligned, "unaligned": write_unaligned,
           "unaligned_labeled": write_unaligned_labeled,
           "unaligned_labeled_cls": write_unaligned_labeled_cls,
           "unaligned_labeled_mask_cls": write_unaligned_labeled_mask_cls,
           "online_ab": write_online_ab, "online_ref": write_online_ref,
           "video": write_video}


if __name__ == "__main__":
    kind, root = sys.argv[1], sys.argv[2]
    n = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    size = int(sys.argv[4]) if len(sys.argv) > 4 else 320
    WRITERS[kind](root, n, size)
    print(f"{kind} dataset at {root}: {n} images of {size} px")
