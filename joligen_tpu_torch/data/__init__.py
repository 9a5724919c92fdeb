"""Host-side data pipeline (``joligen_tpu/data/__init__.py``).

All randomness, PIL decoding and cropping stay on the host; the device sees
fixed-shape NHWC batches ((B, F, H, W, C) clips for the video modes). Ported
modes (``PORTED_MODES``): the labeled-mask modes, ``unaligned_labeled_cls``
(class labels, no masks), their online bbox-crop variants and the four ref
modes, ``unaligned``, ``aligned`` and
``single``, the online video modes and the nuplet mode (ReCUT's and
ReCycleGAN's (N, H, W, C) frames); any other mode raises
``NotImplementedError``. ``list_test_sets`` names a dataroot's test sets
(phase ``test``, ``testA<name>``/``testB<name>``), which the train-time
metrics and ``test.py`` evaluate.
"""

from __future__ import annotations

import glob
import os

from .loader import DataLoader

PORTED_MODES = ("unaligned_labeled_mask", "unaligned_labeled_mask_cls",
                "unaligned_labeled_cls",
                "unaligned_labeled_mask_online",
                "unaligned_labeled_mask_cls_online",
                "self_supervised_labeled_mask",
                "self_supervised_labeled_mask_cls",
                "self_supervised_labeled_mask_online",
                "self_supervised_labeled_mask_cls_online",
                "aligned", "single", "unaligned",
                "unaligned_labeled_mask_ref",
                "unaligned_labeled_mask_online_ref",
                "self_supervised_labeled_mask_ref",
                "self_supervised_labeled_mask_online_ref",
                "temporal_labeled_mask_online",
                "self_supervised_vid_mask_online",
                "self_supervised_vid_labeled_mask_cls_online",
                "nuplet_unaligned_labeled_mask")


def find_dataset_class(mode):
    from . import datasets as D
    table = dict(zip(PORTED_MODES, (D.UnalignedLabeledMaskDataset,
                                    D.UnalignedLabeledMaskClsDataset,
                                    D.UnalignedLabeledClsDataset,
                                    D.UnalignedLabeledMaskOnlineDataset,
                                    D.UnalignedLabeledMaskClsOnlineDataset,
                                    D.SelfSupervisedLabeledMaskDataset,
                                    D.SelfSupervisedLabeledMaskClsDataset,
                                    D.SelfSupervisedLabeledMaskOnlineDataset,
                                    D.SelfSupervisedLabeledMaskClsOnlineDataset,
                                    D.AlignedDataset, D.SingleDataset,
                                    D.UnalignedDataset,
                                    D.UnalignedLabeledMaskRefDataset,
                                    D.UnalignedLabeledMaskOnlineRefDataset,
                                    D.SelfSupervisedLabeledMaskRefDataset,
                                    D.SelfSupervisedLabeledMaskOnlineRefDataset,
                                    D.TemporalLabeledMaskOnlineDataset,
                                    D.SelfSupervisedVidMaskOnlineDataset,
                                    D.SelfSupervisedVidLabeledMaskClsOnlineDataset,
                                    D.NupletUnalignedLabeledMaskDataset)))
    if mode not in table:
        raise NotImplementedError(
            f"dataset mode {mode} is not ported (ported: {PORTED_MODES}; "
            "ROADMAP Queue 1 item 4, dataset modes)")
    return table[mode]


def create_dataset(opt, phase="train", name=""):
    cls = find_dataset_class(opt.data_dataset_mode)
    return cls(opt, phase, name=name)


def create_dataloader(opt, dataset, shuffle=None, batch_size=None,
                      drop_last=None):
    """One data-parallel rank on one card: the batch_size option is the
    batch (per device, as in the reference), capped at the dataset size so
    tiny eval sets still yield full batches. Multi-GPU is ROADMAP Queue 1
    item 15 (multi-GPU)."""
    if batch_size is None:
        batch_size = (opt.train_batch_size if getattr(opt, "isTrain", True)
                      else opt.test_batch_size)
    if shuffle is None:
        shuffle = not getattr(opt, "data_serial_batches", False)
    if drop_last is None:
        drop_last = shuffle  # eval loaders keep the remainder
    return DataLoader(dataset, batch_size=max(1, min(batch_size, len(dataset))),
                      shuffle=shuffle, drop_last=drop_last,
                      prefetch=max(1, getattr(opt, "tpu_prefetch", 2) or 2),
                      num_workers=getattr(opt, "data_num_threads", 4),
                      seed=getattr(opt, "seed", None))


def list_test_sets(dataroot):
    """The names of the test sets under ``dataroot``: the suffixes of its
    ``testA*`` and ``testB*`` entries, sorted (``""`` for ``testA``)."""
    names = set()
    for d in glob.glob(os.path.join(dataroot, "test*")):
        base = os.path.basename(d)
        if base.startswith("testA"):
            names.add(base[len("testA"):])
        elif base.startswith("testB"):
            names.add(base[len("testB"):])
    return sorted(names)
