"""Quality metrics (``joligen_tpu/utils/metrics.py``): exact PSNR and SSIM;
FID, KID and MSID over a feature extractor; the LPIPS and DISTS distances
over a VGG16 trunk (``_VGGish``, which MAT's perceptual loss runs too);
the DINOv2 distance; FVD over clip features; and ``compute_metrics``, the
metric list over two image sets.

Each extractor runs on the device its caller names (``device``; None: the
CUDA device, which raises without a card) and loads a weights file from
``WEIGHTS_DIR`` (``JOLIGEN_TPU_WEIGHTS_DIR``, else
``~/.cache/joligen_tpu``) when one is there, under the JAX package's file
names and npz key contracts: ``inception_v3_fid.npz``, ``vgg16_lpips.npz``,
``i3d_fvd.npz``, ``dinov2_vitb14.npz``. Without it, it runs a fixed-seed
random network (``RandomConvFeatures``, ``RandomConv3D``, the random VGG16
trunk), drawn from an explicit ``torch.Generator`` in flax's default law
(lecun-normal kernels truncated at 2 std, zero biases), and every metric key
computed that way carries ``FALLBACK_MARKER``. The fallbacks' values are
not the JAX package's (another generator), so a fallback score compares
only with scores of the port; the weights files give both packages the
same networks. Images are NHWC in [-1, 1]; the distribution statistics
(``frechet_distance``, KID, MSID) are numpy, as in the JAX package.
"""

from __future__ import annotations

import hashlib
import math
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device
from ..models.convert import flax_to_torch
from ..ops.resize import resize_bilinear

WEIGHTS_DIR = os.environ.get(
    "JOLIGEN_TPU_WEIGHTS_DIR",
    os.path.join(os.path.expanduser("~"), ".cache", "joligen_tpu"))

# appended to every metric name computed with a random-feature fallback
FALLBACK_MARKER = "(random-features)"
WIDTHS = (64, 128, 256, 512, 512)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LPIPS_BATCH = 16      # pairs through the VGG trunk at a time


def _weights_path(fname):
    """The weights file ``fname`` in ``WEIGHTS_DIR``, or None."""
    path = os.path.join(WEIGHTS_DIR, fname)
    return path if os.path.exists(path) else None


def metric_key(name, fallback):
    """Label a metric name when its extractor is a random-feature fallback."""
    return f"{name}{FALLBACK_MARKER}" if fallback else name


def _seeded(module, seed):
    """``module`` with flax's default init drawn from a CPU generator seeded
    ``seed`` (the JAX fallbacks' ``PRNGKey(seed)``), frozen."""
    from ..models.gan_networks import flax_default_init
    return flax_default_init(module, torch.Generator().manual_seed(seed)) \
        .requires_grad_(False)


def _as_tensor(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


# --------------------------------------------------------------------------
# pixel metrics (exact)
# --------------------------------------------------------------------------

def psnr(a, b, data_range=2.0, mask=None, device=None):
    """Per-batch mean PSNR of NHWC ``a`` against ``b`` on ``device``; with
    ``mask`` (1: counted) the squared error is summed inside it over its
    pixel count times ``a``'s channels over its own."""
    device = resolve_device(device=device)
    a, b = _as_tensor(a, device), _as_tensor(b, device)
    if mask is not None:
        m = torch.clamp(_as_tensor(mask, device), 0.0, 1.0)
        mse = (torch.sum(((a - b) * m) ** 2, dim=(1, 2, 3))
               / torch.clamp(torch.sum(m, dim=(1, 2, 3)) * a.shape[-1]
                             / m.shape[-1], min=1.0))
    else:
        mse = torch.mean((a - b) ** 2, dim=(1, 2, 3))
    return float(torch.mean(20.0 * math.log10(data_range)
                            - 10.0 * torch.log10(torch.clamp(mse,
                                                             min=1e-12))))


def _gaussian_kernel(size=11, sigma=1.5):
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(a, b, data_range=2.0, device=None):
    """SSIM (Wang et al.) on ``device``: an 11x11 gaussian window per
    channel, VALID, var = E[x^2] - E[x]^2; NHWC in [-1, 1]; the mean over
    everything."""
    device = resolve_device(device=device)
    a = _as_tensor(a, device).permute(0, 3, 1, 2)
    b = _as_tensor(b, device).permute(0, 3, 1, 2)
    c = a.shape[1]
    kern = torch.from_numpy(_gaussian_kernel()).to(device)[None, None] \
        .repeat(c, 1, 1, 1)

    def filt(x):
        return F.conv2d(x, kern, groups=c)

    mu_a, mu_b = filt(a), filt(b)
    var_a = filt(a * a) - mu_a ** 2
    var_b = filt(b * b) - mu_b ** 2
    cov = filt(a * b) - mu_a * mu_b
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return float(torch.mean(s))


# --------------------------------------------------------------------------
# feature extractors
# --------------------------------------------------------------------------

class RandomConvFeatures(nn.Module):
    """The fallback image extractor: ``depth`` 3x3 stride-2 convs (padding
    1, ``width`` x 2^i channels) each with tanh GELU (flax's ``nn.gelu``),
    the spatial mean, a ``out_dim`` dense layer ``proj``. NHWC in, (N,
    out_dim) out. The modules carry flax's names (``conv{i}``)."""

    def __init__(self, width=64, depth=4, out_dim=2048, in_channels=3):
        super().__init__()
        self.depth = depth
        cin = in_channels
        for i in range(depth):
            self.add_module(f"conv{i}", nn.Conv2d(cin, width * 2 ** i, 3,
                                                  stride=2, padding=1))
            cin = width * 2 ** i
        self.proj = nn.Linear(cin, out_dim)

    def forward(self, x):
        h = x.permute(0, 3, 1, 2)
        for i in range(self.depth):
            h = F.gelu(getattr(self, f"conv{i}")(h), approximate="tanh")
        return self.proj(h.mean(dim=(2, 3)))


def _resized(x, size):
    """NHWC ``x`` resized to ``size`` px (``jax.image.resize`` bilinear,
    antialiased where it shrinks), 1 channel tiled to 3."""
    x = resize_bilinear(x.permute(0, 3, 1, 2), (size, size)).permute(
        0, 2, 3, 1)
    return x.repeat(1, 1, 1, 3) if x.shape[-1] == 1 else x


class InceptionV3Features:
    """(N, H, W, C) [-1, 1] numpy -> (N, 2048) numpy: the FID InceptionV3's
    pool3 features at 299 px when ``inception_v3_fid.npz`` is in
    ``WEIGHTS_DIR``, else ``RandomConvFeatures`` (seed 0) at 128 px."""

    def __init__(self, batch=32, device=None):
        self.batch = batch
        self.device = resolve_device(device=device)
        self._fn = None
        self.is_fallback = _weights_path("inception_v3_fid.npz") is None

    def _build(self):
        path = _weights_path("inception_v3_fid.npz")
        self.is_fallback = path is None
        if path is not None:
            from .inception import InceptionV3FID, load_inception_params
            net, size = InceptionV3FID(), 299
            net.load_state_dict(flax_to_torch(load_inception_params(path)))
        else:
            net, size = _seeded(RandomConvFeatures(), 0), 128
        net = net.to(self.device).eval().requires_grad_(False)
        self._fn = lambda x: net(_resized(x, size))

    def __call__(self, imgs):
        if self._fn is None:
            self._build()
        return batched_extract(self._fn, imgs, self.batch, 2048,
                               self.device)


def batched_extract(fn, imgs, bs, out_dim, device):
    """``fn`` over ``imgs`` in batches of ``bs`` on ``device``, the last
    batch zero-padded to ``bs`` (its padding's rows dropped), as numpy."""
    outs = []
    with torch.inference_mode():
        for i in range(0, imgs.shape[0], bs):
            chunk = np.asarray(imgs[i:i + bs], np.float32)
            pad = bs - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], np.float32)])
            out = fn(torch.from_numpy(chunk).to(device)).float().cpu().numpy()
            outs.append(out[: bs - pad] if pad else out)
    return np.concatenate(outs) if outs else np.zeros((0, out_dim))


class DINOv2Features:
    """(N, H, W, C) [-1, 1] numpy -> L2-normalised embeddings: DINOv2
    ViT-B/14's CLS (768) when ``dinov2_vitb14.npz`` is in ``WEIGHTS_DIR``,
    else ``RandomConvFeatures`` (seed 1) at 128 px, normalised (2048)."""

    def __init__(self, batch=16, device=None):
        self.batch = batch
        self.device = resolve_device(device=device)
        self._fn = None
        self.is_fallback = _weights_path("dinov2_vitb14.npz") is None

    def _build(self):
        path = _weights_path("dinov2_vitb14.npz")
        self.is_fallback = path is None
        if path is not None:
            from .dinov2 import DINOv2ViT, load_dinov2_params, preprocess
            net = DINOv2ViT()
            net.load_state_dict(flax_to_torch(load_dinov2_params(path)))
            net = net.to(self.device).eval().requires_grad_(False)
            self._fn = lambda x: net(preprocess(x))
            return
        net = _seeded(RandomConvFeatures(), 1).to(self.device).eval()

        def run(x):
            f = net(_resized(x, 128))
            return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
        self._fn = run

    def __call__(self, imgs):
        if self._fn is None:
            self._build()
        return batched_extract(self._fn, imgs, self.batch, 768, self.device)


def dinov2_distance(fakes, reals, extractor=None, device=None):
    """Paired mean (1 - cosine similarity) of DINOv2 embeddings."""
    extractor = extractor or DINOv2Features(device=device)
    f = extractor(fakes)
    r = extractor(reals)
    return float(np.mean(1.0 - np.sum(f * r, axis=1)))


# --------------------------------------------------------------------------
# distribution metrics (numpy)
# --------------------------------------------------------------------------

def _cov_mean(acts):
    mu = acts.mean(axis=0)
    sigma = np.cov(acts, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """FID between two gaussians: tr(sqrtm(s1 s2)) from the eigenvalues of
    s1 @ s2 (real and >= 0 for PSD factors; the rest is noise), no scipy."""
    diff = mu1 - mu2
    s1 = np.atleast_2d(sigma1)
    s2 = np.atleast_2d(sigma2)
    eigvals = np.clip(np.real(np.linalg.eigvals(s1 @ s2)), 0.0, None)
    covmean_trace = np.sum(np.sqrt(eigvals))
    return float(max(0.0, diff @ diff + np.trace(s1) + np.trace(s2)
                     - 2.0 * covmean_trace))


def fid_from_acts(acts1, acts2):
    mu1, s1 = _cov_mean(acts1)
    mu2, s2 = _cov_mean(acts2)
    return frechet_distance(mu1, s1, mu2, s2)


def kid_from_acts(acts1, acts2, subset_size=100, n_subsets=10, seed=0):
    """Kernel Inception Distance: the cubic polynomial kernel's MMD^2 over
    ``n_subsets`` subsets drawn by ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    m = min(subset_size, len(acts1), len(acts2))
    if m < 2:
        return 0.0
    d = acts1.shape[1]

    def poly(x, y):
        return (x @ y.T / d + 1.0) ** 3

    vals = []
    for _ in range(n_subsets):
        xi = acts1[rng.choice(len(acts1), m, replace=False)]
        yi = acts2[rng.choice(len(acts2), m, replace=False)]
        kxx = poly(xi, xi)
        kyy = poly(yi, yi)
        kxy = poly(xi, yi)
        mmd = ((kxx.sum() - np.trace(kxx)) / (m * (m - 1))
               + (kyy.sum() - np.trace(kyy)) / (m * (m - 1))
               - 2.0 * kxy.mean())
        vals.append(mmd)
    return float(np.mean(vals))


def msid_from_acts(acts1, acts2, n_moments=8):
    """The JAX package's MSID approximation: the absolute difference of the
    first ``n_moments`` moments of the normalised graph Laplacian's
    spectrum of a gaussian kernel over (at most 512) activations."""
    def spectrum_moments(a):
        a = a[: min(len(a), 512)]
        d2 = ((a[:, None] - a[None]) ** 2).sum(-1)
        sig = np.median(d2) + 1e-9
        w = np.exp(-d2 / sig)
        deg = w.sum(1)
        lap = np.eye(len(a)) - w / np.sqrt(np.outer(deg, deg) + 1e-12)
        ev = np.clip(np.linalg.eigvalsh(lap), 0, 2)
        return np.array([np.mean(ev ** k) for k in range(1, n_moments + 1)])

    m1 = spectrum_moments(acts1)
    m2 = spectrum_moments(acts2)
    return float(np.abs(m1 - m2).sum())


# --------------------------------------------------------------------------
# perceptual distances over the VGG16 trunk
# --------------------------------------------------------------------------

class _VGGish(nn.Module):
    """VGG16 topology: 5 stages of 3x3 convs (2, 2, 3, 3, 3) with ReLU, a
    2x2 max pool after each; returns the 5 stages' features (after their
    ReLU, before their pool), NHWC, from an NHWC input. ``generator``
    (CPU) draws flax's default init: lecun-normal kernels truncated at 2
    std, zero biases."""

    def __init__(self, in_channels=3, generator=None):
        super().__init__()
        cin = in_channels
        for bi, w in enumerate(WIDTHS):
            for ci in range(2 if bi < 2 else 3):
                self.add_module(f"b{bi}c{ci}", nn.Conv2d(cin, w, 3,
                                                         padding=1))
                cin = w
        with torch.no_grad():
            for conv in self.children():
                fan_in = conv.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
                conv.bias.zero_()

    def forward(self, x):
        feats = []
        h = x.permute(0, 3, 1, 2)
        for bi in range(len(WIDTHS)):
            for ci in range(2 if bi < 2 else 3):
                h = F.relu(getattr(self, f"b{bi}c{ci}")(h))
            feats.append(h.permute(0, 2, 3, 1))
            if bi < len(WIDTHS) - 1:
                h = F.max_pool2d(h, 2)
        return feats


def load_vgg_params(path):
    """The flax tree of ``vgg16_lpips.npz`` (``b{i}c{j}/kernel`` HWIO and
    ``b{i}c{j}/bias``), as the JAX ``vgg_feature_fn`` reads it."""
    raw = np.load(path)
    return {"params": {k: {"kernel": raw[f"{k}/kernel"],
                           "bias": raw[f"{k}/bias"]}
                       for k in sorted({n.split("/")[0] for n in raw.files})}}


def vgg_feature_fn(shape, mean=None, std=None, device=None):
    """``feats(x) -> [5 stage features]`` over the frozen VGG16 trunk on
    ``device``: the weights of ``vgg16_lpips.npz`` when it is in
    ``WEIGHTS_DIR`` (the input then ImageNet-normalised from [-1, 1];
    ``mean``/``std`` override the normalisation), else the fixed random
    trunk (seed 0, the input as it is). ``shape`` is (H, W, 3). The trunk
    computes in fp32 and takes no gradient; the input keeps its graph."""
    if shape[-1] != 3:
        raise ValueError(f"the VGG16 trunk takes 3 channels, not {shape}")
    device = resolve_device(device=device)
    path = _weights_path("vgg16_lpips.npz")
    if path is not None:
        net = _VGGish()
        net.load_state_dict(flax_to_torch(load_vgg_params(path)))
        m = torch.tensor(IMAGENET_MEAN if mean is None else mean,
                         dtype=torch.float32, device=device)
        s = torch.tensor(IMAGENET_STD if std is None else std,
                         dtype=torch.float32, device=device)
    else:
        net = _VGGish(generator=torch.Generator().manual_seed(0))
    net = net.to(device).eval().requires_grad_(False)

    def feats(x):
        x = x.float()
        if path is not None:
            x = ((x + 1.0) / 2.0 - m) / s
        return net(x)

    feats.trunk = net
    return feats


def lpips_from_feats(fa, fb):
    """LPIPS per sample: each stage's channels unit-normalised, the squared
    difference summed over channels, averaged over space, then over
    stages."""
    d = 0.0
    for x, y in zip(fa, fb):
        xn = x / torch.sqrt(torch.sum(x ** 2, -1, keepdim=True) + 1e-10)
        yn = y / torch.sqrt(torch.sum(y ** 2, -1, keepdim=True) + 1e-10)
        d = d + torch.mean(torch.sum((xn - yn) ** 2, dim=-1), dim=(1, 2))
    return d / len(fa)


def dists_from_feats(fa, fb, c1=1e-6, c2=1e-6):
    """DISTS per sample: per stage and channel, the structure term of the
    spatial means and the texture term of the (biased) variances and
    covariance, their mean, uniformly averaged; 1 minus that."""
    vals = 0.0
    for x, y in zip(fa, fb):
        mx = torch.mean(x, dim=(1, 2))
        my = torch.mean(y, dim=(1, 2))
        vx = torch.var(x, dim=(1, 2), unbiased=False)
        vy = torch.var(y, dim=(1, 2), unbiased=False)
        cxy = torch.mean((x - mx[:, None, None]) * (y - my[:, None, None]),
                         dim=(1, 2))
        s = (2 * mx * my + c1) / (mx ** 2 + my ** 2 + c1)
        t = (2 * cxy + c2) / (vx + vy + c2)
        vals = vals + torch.mean((s + t) / 2.0, dim=-1)
    return 1.0 - vals / len(fa)


class LPIPS:
    """``lpips(a, b)``: the mean LPIPS of two NHWC numpy sets (1 channel
    tiled to 3) on ``device``, LPIPS_BATCH pairs at a time."""

    def __init__(self, device=None):
        self.device = resolve_device(device=device)
        self._fn = None
        self.is_fallback = _weights_path("vgg16_lpips.npz") is None

    def __call__(self, a, b):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        if a.shape[-1] == 1:
            a = np.tile(a, (1, 1, 1, 3))
            b = np.tile(b, (1, 1, 1, 3))
        if self._fn is None:
            self.is_fallback = _weights_path("vgg16_lpips.npz") is None
            self._fn = vgg_feature_fn(a.shape[1:], device=self.device)
        vals = []
        with torch.inference_mode():
            for i in range(0, len(a), LPIPS_BATCH):
                ta = torch.from_numpy(a[i:i + LPIPS_BATCH]).to(self.device)
                tb = torch.from_numpy(b[i:i + LPIPS_BATCH]).to(self.device)
                vals.append(lpips_from_feats(self._fn(ta), self._fn(tb)))
        return float(torch.mean(torch.cat(vals)))


# --------------------------------------------------------------------------
# activation statistics cache
# --------------------------------------------------------------------------

def compute_statistics_of_images(extractor, imgs, cache_path=None):
    """(mu, sigma, acts) of ``extractor(imgs)``, read from and written to
    ``cache_path`` (npz) when given."""
    if cache_path and os.path.exists(cache_path):
        data = np.load(cache_path)
        return data["mu"], data["sigma"], data.get("acts")
    acts = extractor(imgs)
    mu, sigma = _cov_mean(acts)
    if cache_path:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        np.savez(cache_path, mu=mu, sigma=sigma, acts=acts)
    return mu, sigma, acts


def cache_path_for(root, domain, size, phase="train"):
    tag = hashlib.md5(f"{os.path.abspath(root)}_{domain}_{size}_{phase}"
                      .encode()).hexdigest()[:12]
    return os.path.join(root, f"fid_stats_{domain}_{phase}_{size}_{tag}.npz")


# --------------------------------------------------------------------------
# FVD: the Fréchet distance of clip features
# --------------------------------------------------------------------------

class RandomConv3D(nn.Module):
    """The fallback clip extractor: three 3x3x3 convs (strides (1, 2, 2),
    padding 1; 32, 64, 128 channels) each with tanh GELU, then the
    spatio-temporal mean. (N, F, H, W, C) in, (N, 128) out; flax's names
    ``c{i}``."""

    def __init__(self, in_channels=3):
        super().__init__()
        cin = in_channels
        for i, w in enumerate((32, 64, 128)):
            self.add_module(f"c{i}", nn.Conv3d(cin, w, 3, stride=(1, 2, 2),
                                               padding=1))
            cin = w

    def forward(self, x):
        h = x.permute(0, 4, 1, 2, 3)
        for i in range(3):
            h = F.gelu(getattr(self, f"c{i}")(h), approximate="tanh")
        return h.mean(dim=(2, 3, 4))


class VideoFeatures:
    """(N, F, H, W, C) [-1, 1] numpy clips -> features: I3D's 400 logits at
    224 px when ``i3d_fvd.npz`` is in ``WEIGHTS_DIR``, else
    ``RandomConv3D`` (seed 0); ``batch`` clips at a time."""

    def __init__(self, batch=8, device=None):
        self.batch = batch
        self.device = resolve_device(device=device)
        self._fn = None
        self.is_fallback = _weights_path("i3d_fvd.npz") is None

    def _build(self):
        path = _weights_path("i3d_fvd.npz")
        self.is_fallback = path is None
        if path is None:
            net = _seeded(RandomConv3D(), 0).to(self.device).eval()
            self._fn = net
            return
        from .i3d import I3D, load_i3d_params
        net = I3D()
        net.load_state_dict(flax_to_torch(load_i3d_params(path)))
        net = net.to(self.device).eval().requires_grad_(False)

        def run(x):
            n, f = x.shape[:2]
            x = _resized(x.reshape((n * f,) + x.shape[2:]), 224)
            return net(x.reshape((n, f) + x.shape[1:]))
        self._fn = run

    def __call__(self, clips):
        if self._fn is None:
            self._build()
        outs = []
        with torch.inference_mode():
            for i in range(0, len(clips), self.batch):
                x = torch.from_numpy(np.asarray(clips[i:i + self.batch],
                                                np.float32)).to(self.device)
                outs.append(self._fn(x).float().cpu().numpy())
        return np.concatenate(outs)


def fvd(real_clips, fake_clips, extractor=None, device=None):
    """Fréchet Video Distance of two clip sets."""
    extractor = extractor or VideoFeatures(device=device)
    a1 = extractor(np.asarray(real_clips, np.float32))
    a2 = extractor(np.asarray(fake_clips, np.float32))
    return fid_from_acts(a1, a2)


# --------------------------------------------------------------------------
# the metric list over two image sets
# --------------------------------------------------------------------------

def compute_metrics(fakes, reals, metrics_list, extractor=None,
                    real_stats=None, mask=None, device=None):
    """fakes/reals: (N, H, W, C) numpy in [-1, 1]. Returns {metric: value}
    in the JAX order: FID, KID, MSID (one extraction; ``real_stats`` (mu,
    sigma, acts) in place of the reals'), PSNR (``mask``), SSIM, LPIPS,
    DINOv2; each extractor on ``device``."""
    device = resolve_device(device=device)
    out = {}
    if any(m in metrics_list for m in ("FID", "KID", "MSID")):
        extractor = extractor or InceptionV3Features(device=device)
        fb = bool(getattr(extractor, "is_fallback", False))
        fake_acts = extractor(fakes)
        if real_stats is not None:
            mu_r, sigma_r, real_acts = real_stats
        else:
            real_acts = extractor(reals)
            mu_r, sigma_r = _cov_mean(real_acts)
        if "FID" in metrics_list:
            mu_f, sigma_f = _cov_mean(fake_acts)
            out[metric_key("FID", fb)] = frechet_distance(
                mu_f, sigma_f, mu_r, sigma_r)
        if "KID" in metrics_list and real_acts is not None:
            out[metric_key("KID", fb)] = kid_from_acts(fake_acts, real_acts)
        if "MSID" in metrics_list and real_acts is not None:
            out[metric_key("MSID", fb)] = msid_from_acts(fake_acts, real_acts)
    if "PSNR" in metrics_list:
        out["PSNR"] = psnr(fakes, reals, mask=mask, device=device)
    if "SSIM" in metrics_list:
        out["SSIM"] = ssim(fakes, reals, device=device)
    if "LPIPS" in metrics_list:
        lp = LPIPS(device=device)
        out[metric_key("LPIPS", lp.is_fallback)] = lp(fakes, reals)
    if "DINOv2" in metrics_list:
        dv = DINOv2Features(device=device)
        out[metric_key("DINOv2", dv.is_fallback)] = dinov2_distance(
            fakes, reals, extractor=dv)
    return out
