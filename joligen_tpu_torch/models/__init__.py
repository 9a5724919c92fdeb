"""Model layer of the port."""


def create_model(opt, phase="train", device=None, cpu=False):
    """Name -> model class (``joligen_tpu/models/__init__.py``) for phase
    ``train`` or ``test``: palette, cm, cm_gan, sc, b2b, cut, re_cut,
    re_cut_semantic_mask (which sets ``train_semantic_mask``), cycle_gan,
    re_cycle_gan, mat, segmentation and test are ported
    (re_cycle_gan_semantic_mask raises as in the JAX package). The device
    is CUDA unless ``cpu`` or an explicit ``device`` is given."""
    if opt.model_type == "palette":
        from .palette_model import PaletteModel
        return PaletteModel(opt, phase=phase, device=device, cpu=cpu)
    if opt.model_type in ("cm", "cm_gan"):
        from .cm_model import CMModel
        return CMModel(opt, phase=phase, device=device, cpu=cpu)
    if opt.model_type == "sc":
        from .sc_model import SCModel
        return SCModel(opt, phase=phase, device=device, cpu=cpu)
    if opt.model_type == "b2b":
        from .b2b_model import B2BModel
        return B2BModel(opt, phase=phase, device=device, cpu=cpu)
    if opt.model_type in ("cut", "re_cut", "re_cut_semantic_mask"):
        from .cut_model import CUTModel
        if opt.model_type == "re_cut_semantic_mask":
            opt.train_semantic_mask = True
        return CUTModel(opt, phase=phase, device=device, cpu=cpu)
    if opt.model_type in ("cycle_gan", "re_cycle_gan",
                          "re_cycle_gan_semantic_mask"):
        from .cycle_gan_model import CycleGANModel
        return CycleGANModel(opt, phase=phase, device=device, cpu=cpu)
    if opt.model_type == "mat":
        from .mat_model import MATModel
        return MATModel(opt, phase=phase, device=device, cpu=cpu)
    if opt.model_type == "segmentation":
        from .segmentation_model import SegmentationModel
        return SegmentationModel(opt, phase=phase, device=device, cpu=cpu)
    if opt.model_type == "test":
        from .test_model import TestModel
        return TestModel(opt, phase=phase, device=device, cpu=cpu)
    raise NotImplementedError(
        f"model type {opt.model_type}: palette, cm, cm_gan, sc, b2b, cut, "
        "re_cut, re_cut_semantic_mask, cycle_gan, re_cycle_gan, mat, "
        "segmentation and test are ported")
