"""Model layer of the port."""


def create_model(opt, phase="train", device=None, cpu=False):
    """Name -> model class (``joligen_tpu/models/__init__.py``) for phase
    ``train`` or ``test``: palette, cm, cm_gan, sc, b2b (video), cut and
    test are ported. The device is CUDA unless ``cpu`` or an explicit ``device`` is
    given."""
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
    if opt.model_type == "cut":
        from .cut_model import CUTModel
        return CUTModel(opt, phase=phase, device=device, cpu=cpu)
    if opt.model_type == "test":
        from .test_model import TestModel
        return TestModel(opt, phase=phase, device=device, cpu=cpu)
    raise NotImplementedError(
        f"model type {opt.model_type}: palette, cm, cm_gan, sc, b2b, cut and "
        "test are ported (ROADMAP Queue 1 items 9 to 13, the model families after "
        "the main path)")
