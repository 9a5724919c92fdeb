"""B2B flow matching (``joligen_tpu/models/modules/b2b.py``): x-prediction
turned into a velocity v = (x_pred - z) / max(1 - t, t_eps), logistic-normal
t with uniform mixing, masked noising and projection, classifier-free label
dropout (the null class is ``num_classes``), the 6-d mask-bbox descriptor,
and the Heun ODE sampler with a final Euler step and interval-gated CFG.

Random draws come from the caller's ``torch.Generator`` unless ``draws``
feeds them (tests feed the JAX keys' draws):

- ``b2b_training_outputs``: ``t_normal``, ``t_uniform`` and ``t_mix`` (B,)
  (``sample_t``), ``noise`` like y0, ``drop`` (B,) (``drop_labels``), and
  on the autoregressive video branch ``use_gt`` (B,), ``ref_idx`` (B,)
  ints, ``degrade`` (B,) and ``degrade_noise`` like y0;
- ``b2b_sample``: ``noise`` like y.

Video tensors are (B, F, H, W, C); images (B, H, W, C).
"""

from __future__ import annotations

import torch


def _draw(draws, name, make):
    v = draws.get(name)
    return make() if v is None else v


def sample_t(generator, batch, device, P_mean=-0.8, P_std=0.8,
             uniform_mix_prob=0.1, draws=None):
    """sigmoid(N(0, 1) * P_std + P_mean), replaced by U(0, 1) with
    probability ``uniform_mix_prob``."""
    draws = draws or {}
    normal = _draw(draws, "t_normal", lambda: torch.randn(
        (batch,), generator=generator, device=device))
    t = torch.sigmoid(normal.to(device) * P_std + P_mean)
    if uniform_mix_prob <= 0:
        return t
    t_u = _draw(draws, "t_uniform", lambda: torch.rand(
        (batch,), generator=generator, device=device))
    mix = _draw(draws, "t_mix", lambda: torch.rand(
        (batch,), generator=generator, device=device))
    return torch.where(mix.to(device) < uniform_mix_prob, t_u.to(device), t)


def drop_labels(generator, labels, num_classes, drop_prob, draws=None):
    """Each label replaced by the null class ``num_classes`` with
    probability ``drop_prob``."""
    if drop_prob <= 0 or labels is None:
        return labels
    u = _draw(draws or {}, "drop", lambda: torch.rand(
        labels.shape, generator=generator, device=labels.device))
    return torch.where(u.to(labels.device) < drop_prob,
                       torch.full_like(labels, num_classes), labels)


def mask_size_condition(mask, H, W):
    """The mask's bbox descriptor [cx, cy, w, h, area, log_aspect] per
    leading index (zeros where the mask is empty). mask (..., H, W, 1) ->
    (..., 6)."""
    flat = (mask[..., 0] > 0.5).reshape(-1, H, W)
    positive = flat.any(dim=2).any(dim=1)
    area = flat.float().mean(dim=(1, 2))
    y_any = flat.any(dim=2)
    x_any = flat.any(dim=1)
    dev = mask.device
    y_idx = torch.arange(H, dtype=torch.float32, device=dev)[None]
    x_idx = torch.arange(W, dtype=torch.float32, device=dev)[None]
    y_min = torch.where(y_any, y_idx, float(H)).amin(dim=1)
    y_max = torch.where(y_any, y_idx, -1.0).amax(dim=1)
    x_min = torch.where(x_any, x_idx, float(W)).amin(dim=1)
    x_max = torch.where(x_any, x_idx, -1.0).amax(dim=1)
    width = (x_max - x_min + 1.0) / max(1, W)
    height = (y_max - y_min + 1.0) / max(1, H)
    cx = (x_min + x_max + 1.0) / (2.0 * max(1, W))
    cy = (y_min + y_max + 1.0) / (2.0 * max(1, H))
    log_aspect = torch.clamp(torch.log((width + 1e-6) / (height + 1e-6)),
                             -3.0, 3.0) / 3.0
    feats = torch.stack([cx, cy, width, height, area, log_aspect], dim=1)
    feats = torch.where(positive[:, None], feats, torch.zeros_like(feats))
    return feats.reshape(mask.shape[:-3] + (6,))


def _bcast(t, ndim):
    return t.reshape(t.shape + (1,) * (ndim - t.ndim))


def b2b_training_outputs(apply_fn, generator, y0, y_cond=None, mask=None,
                         labels=None, num_classes=1, noise_scale=1.0,
                         P_mean=-0.8, P_std=0.8, uniform_mix_prob=0.1,
                         t_eps=5e-2, label_drop_prob=0.0, mask_size=None,
                         use_gt_prob=0.0, degrade_prob=0.0, degrade_std=0.0,
                         minsnr=False, draws=None):
    """One training forward. ``apply_fn(z_in, t, labels, mask_size)``.
    Returns (v_pred, v_target, loss_mask, raw_x_pred, is_ref): with
    ``use_gt_prob`` > 0 on video, one frame of each clip chosen with that
    probability is its clean ground truth at t = 1 (optionally degraded by
    Gaussian noise), left out of the loss and flagged in ``is_ref``
    (B, F, 1, 1, 1); else is_ref is None. ``minsnr`` weighs both sides by
    sqrt(min(SNR, 5) / (SNR + 1)), SNR = (t / (1 - t))²."""
    draws = draws or {}
    b, dev, dt = y0.shape[0], y0.device, y0.dtype
    video = y0.ndim == 5

    def rand(name, shape):
        return _draw(draws, name, lambda: torch.rand(
            shape, generator=generator, device=dev)).to(dev)

    def randn(name):
        return _draw(draws, name, lambda: torch.randn(
            y0.shape, generator=generator, device=dev, dtype=dt)).to(dev, dt)

    t = sample_t(generator, b, dev, P_mean, P_std, uniform_mix_prob, draws)
    m = None if mask is None else torch.clamp(mask.to(dt), 0.0, 1.0)
    e = randn("noise") * noise_scale
    loss_mask = m
    autoregressive = video and use_gt_prob > 0.0
    if autoregressive:
        f = y0.shape[1]
        use_gt = rand("use_gt", (b,)) < use_gt_prob
        ref_idx = _draw(draws, "ref_idx", lambda: torch.randint(
            0, f, (b,), generator=generator, device=dev)).to(dev)
        is_ref = ((torch.arange(f, device=dev)[None, :] == ref_idx[:, None])
                  & use_gt[:, None])
        t_frames = torch.where(is_ref, torch.ones_like(t)[:, None],
                               t[:, None])                     # (B, F)
        tb = _bcast(t_frames, y0.ndim)
        z_t = tb * y0 + (1.0 - tb) * e
        degrade = (rand("degrade", (b,)) < degrade_prob) & use_gt
        gt_ref = y0 + degrade_std * randn("degrade_noise") * _bcast(
            degrade.to(dt), y0.ndim)
        z_t = torch.where(_bcast(is_ref, y0.ndim), gt_ref, z_t)
        keep = 1.0 - _bcast(is_ref.to(dt), y0.ndim)
        loss_mask = keep if m is None else m * keep
        t_model = t_frames
    else:
        tb = _bcast(t, y0.ndim)
        z_t = tb * y0 + (1.0 - tb) * e
        t_model = t

    z = z_t * m + (1.0 - m) * y0 if m is not None else z_t
    labels_d = drop_labels(generator, labels, num_classes, label_drop_prob,
                           draws)
    z_in = z if y_cond is None else torch.cat([y_cond, z], dim=-1)
    denom = torch.clamp(1.0 - tb, min=t_eps)
    v_target = (y0 - z) / denom
    raw_x_pred = apply_fn(z_in, t_model, labels_d, mask_size)
    x_pred = raw_x_pred * m + (1.0 - m) * y0 if m is not None else raw_x_pred
    v_pred = (x_pred - z) / denom
    if minsnr:
        snr = (tb / torch.clamp(1.0 - tb, min=t_eps)) ** 2
        sw = torch.sqrt(torch.clamp(snr, max=5.0) / (snr + 1.0))
        v_pred = v_pred * sw
        v_target = v_target * sw
    is_ref_b = _bcast(is_ref.to(dt), y0.ndim) if autoregressive else None
    return v_pred, v_target, loss_mask, raw_x_pred, is_ref_b


@torch.no_grad()
def b2b_sample(apply_fn, generator, y, y_cond=None, mask=None, labels=None,
               num_classes=1, denoise_timesteps=50, noise_scale=1.0,
               t_eps=5e-2, cfg_scale=1.0, cfg_interval=(0.1, 1.0),
               clip_denoised=False, mask_size=None, draws=None):
    """Heun steps over t = 0 .. 1 in ``denoise_timesteps`` intervals, the
    last one an Euler step: 2 * steps - 1 denoiser calls (twice that inside
    the CFG interval when CFG is on). Outside the mask the output is y.
    Returns the clip or image clipped to [-1, 1]."""
    b, dev = y.shape[0], y.device
    m = None if mask is None else torch.clamp(mask.to(y.dtype), 0.0, 1.0)
    y_bg = y * (1.0 - m) if m is not None else y
    noise = _draw(draws or {}, "noise", lambda: torch.randn(
        y.shape, generator=generator, device=dev, dtype=y.dtype)).to(dev)
    x = y_bg + noise * noise_scale
    if m is not None:
        x = x * m + y * (1.0 - m)
    if labels is None:
        labels = torch.zeros((b,), dtype=torch.long, device=dev)
    use_cfg = cfg_scale != 1.0 and num_classes > 1
    null = torch.full((b,), num_classes, dtype=torch.long, device=dev)

    def velocity(x, t):
        x_in = x * m + y * (1.0 - m) if m is not None else x
        z_in = x_in if y_cond is None else torch.cat([y_cond, x_in], dim=-1)
        tvec = torch.full((b,), t, dtype=x.dtype, device=dev)
        den = max(1.0 - t, t_eps)
        x_pred = apply_fn(z_in, tvec, labels, mask_size)
        if m is not None:
            x_pred = x_pred * m + y * (1.0 - m)
        v_cond = (x_pred - x_in) / den
        lo, hi = cfg_interval
        # the unconditional call only inside the CFG interval
        if not (use_cfg and t < hi and (lo == 0 or t > lo)):
            return v_cond
        xu = apply_fn(z_in, tvec, null, mask_size)
        if m is not None:
            xu = xu * m + y * (1.0 - m)
        v_uncond = (xu - x_in) / den
        return v_uncond + cfg_scale * (v_cond - v_uncond)

    def project(x):
        if clip_denoised:
            x = torch.clamp(x, -1.0, 1.0)
        if m is not None:
            x = x * m + y * (1.0 - m)
        return x

    steps = int(denoise_timesteps)
    # the JAX package's float32 linspace, read on the host
    ts = torch.linspace(0.0, 1.0, steps + 1, dtype=torch.float32).tolist()
    for i in range(steps - 1):
        t, dt_ = ts[i], ts[i + 1] - ts[i]
        v_t = velocity(x, t)
        v_next = velocity(x + dt_ * v_t, ts[i + 1])
        x = project(x + dt_ * 0.5 * (v_t + v_next))
    x = x + (ts[steps] - ts[steps - 1]) * velocity(x, ts[steps - 1])
    return torch.clamp(project(x), -1.0, 1.0)
