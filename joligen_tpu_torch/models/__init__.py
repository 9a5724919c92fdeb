"""Model layer of the port."""


def create_model(opt, phase="train", device=None, cpu=False):
    """Name -> model class (``joligen_tpu/models/__init__.py``) for phase
    ``train`` or ``test``. Only the palette model is ported; the device is
    CUDA unless ``cpu`` or an explicit ``device`` is given."""
    if opt.model_type == "palette":
        from .palette_model import PaletteModel
        return PaletteModel(opt, phase=phase, device=device, cpu=cpu)
    raise NotImplementedError(
        f"model type {opt.model_type}: only palette is ported (ROADMAP Queue 1)")
