"""DiffAugment for discriminator inputs (``joligen_tpu/ops/diff_aug.py``),
on NCHW tensors, split into draws and their application.

The JAX package draws inside each policy from a key. Here
``draw_diff_augment`` makes a batch's draws with a ``torch.Generator`` (on
the images' device) and ``apply_diff_augment`` applies given draws, so a
test can feed both packages the same draws. The draws are the raw samples
the JAX functions take from ``jax.random``:

- ``color``: ``brightness``, ``saturation``, ``contrast``, (N,) uniforms;
- ``translation``: ``ty``, ``tx``, (N,) ints in [-sh, sh] and [-sw, sw];
- ``cutout``: ``cy``, ``cx``, (N,) ints in [0, H) and [0, W);
- ``noise``: ``noise``, (N, C, H, W) standard normals;
- ``resize``: ``zoom``, ``oy``, ``ox``, (N,) uniforms;
- ``use``: a bool scalar, the batch's gate (``u < prob``), absent when
  ``prob >= 1``.

The gate is applied with ``torch.where``, as JAX does: the augmented batch
is always computed and the host never reads a draw.
"""

from __future__ import annotations

import torch

from .resize import scale_and_translate

TRANSLATION_RATIO, CUTOUT_RATIO, NOISE_STD, RESIZE_SCALE = 0.125, 0.5, 0.1, 0.25


def _policies(policy):
    return [p.strip() for p in (policy or "").split(",")
            if p.strip() in ("color", "translation", "cutout", "noise",
                             "resize")]


def draw_diff_augment(generator, shape, policy, prob=1.0, device=None):
    """The draws of one batch of NCHW ``shape``; None without a policy."""
    pols = _policies(policy)
    if not pols:
        return None
    n, c, h, w = shape
    device = device if device is not None else generator.device
    kw = dict(generator=generator, device=device)

    def uniform(*size):
        return torch.rand(size, dtype=torch.float32, **kw)

    d = {}
    for p in pols:
        if p == "color":
            d["brightness"], d["saturation"], d["contrast"] = (
                uniform(n), uniform(n), uniform(n))
        elif p == "translation":
            sh, sw = max(1, int(h * TRANSLATION_RATIO)), max(
                1, int(w * TRANSLATION_RATIO))
            d["ty"] = torch.randint(-sh, sh + 1, (n,), **kw)
            d["tx"] = torch.randint(-sw, sw + 1, (n,), **kw)
        elif p == "cutout":
            d["cy"] = torch.randint(0, h, (n,), **kw)
            d["cx"] = torch.randint(0, w, (n,), **kw)
        elif p == "noise":
            d["noise"] = torch.randn((n, c, h, w), dtype=torch.float32, **kw)
        elif p == "resize":
            d["zoom"], d["oy"], d["ox"] = uniform(n), uniform(n), uniform(n)
    if prob < 1.0:
        d["use"] = uniform() < prob
    return d


def _brightness(x, u):
    return x + (u.to(x.dtype)[:, None, None, None] - 0.5)


def _saturation(x, u):
    s = u.to(x.dtype)[:, None, None, None] * 2.0
    mean = x.mean(dim=1, keepdim=True)
    return (x - mean) * s + mean


def _contrast(x, u):
    c = u.to(x.dtype)[:, None, None, None] + 0.5
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * c + mean


def _translation(x, ty, tx):
    n, c, h, w = x.shape
    sh, sw = max(1, int(h * TRANSLATION_RATIO)), max(
        1, int(w * TRANSLATION_RATIO))
    pad = torch.nn.functional.pad(x, (sw, sw, sh, sh))
    rows = torch.arange(h, device=x.device)[None] + sh + ty[:, None]
    cols = torch.arange(w, device=x.device)[None] + sw + tx[:, None]
    nn_ = torch.arange(n, device=x.device)[:, None, None, None]
    cc = torch.arange(c, device=x.device)[None, :, None, None]
    return pad[nn_, cc, rows[:, None, :, None], cols[:, None, None, :]]


def _cutout(x, cy, cx):
    n, c, h, w = x.shape
    ch, cw = max(1, int(h * CUTOUT_RATIO)), max(1, int(w * CUTOUT_RATIO))
    cy, cx = cy[:, None, None], cx[:, None, None]
    ys = torch.arange(h, device=x.device)[None, :, None]
    xs = torch.arange(w, device=x.device)[None, None, :]
    inside = ((ys >= cy - ch // 2) & (ys < cy + ch - ch // 2)
              & (xs >= cx - cw // 2) & (xs < cx + cw - cw // 2))
    return x * (1.0 - inside[:, None].to(x.dtype))


def _resize_crop(x, zoom, oy, ox):
    n, c, h, w = x.shape
    s = 1.0 + RESIZE_SCALE * zoom
    dy = oy * (h - h / s)
    dx = ox * (w - w / s)
    return scale_and_translate(x, s, torch.stack([-dy * s, -dx * s], 1))


def apply_diff_augment(x, draws, policy):
    """The policy applied to ``x`` with ``draws`` (from
    ``draw_diff_augment``), gated by ``draws["use"]`` when present."""
    if draws is None or not _policies(policy):
        return x
    y = x
    for p in _policies(policy):
        if p == "color":
            y = _brightness(y, draws["brightness"])
            y = _saturation(y, draws["saturation"])
            y = _contrast(y, draws["contrast"])
        elif p == "translation":
            y = _translation(y, draws["ty"], draws["tx"])
        elif p == "cutout":
            y = _cutout(y, draws["cy"], draws["cx"])
        elif p == "noise":
            y = y + NOISE_STD * draws["noise"].to(y.dtype)
        elif p == "resize":
            y = _resize_crop(y, draws["zoom"], draws["oy"], draws["ox"])
    if "use" in draws:
        return torch.where(draws["use"], y, x)
    return y
