"""CUT machinery (``joligen_tpu/models/modules/cut_networks.py``): the patch
feature sampler ``PatchSampleF``, the patch ids it samples, the contrastive
losses (PatchNCE, MoNCE with its Sinkhorn, SRC + hDCE) and the GAN losses.

``sample_patch_ids`` takes a ``torch.Generator``: one id set a layer, shared
by the batch, drawn without replacement. Tests feed ids drawn with
``jax.random`` instead.

MoNCE runs its 50 Sinkhorn iterations in the features' dtype with the
``1e-12`` and ``1e-8`` guards; only ``feat_k`` is detached, so the
gradient flows through every iteration and through ``log(f)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .unet_mha import Dense


class PatchSampleF(nn.Module):
    """``mlp_sample`` projector: for each layer, the features at the patch
    ids, a 2-layer MLP (``mlp_{i}_0``, ``mlp_{i}_1``) and an L2 norm.
    ``forward(feats, patch_ids)``: NHWC features, (P,) int64 ids a layer ->
    list of (B·P, nc) fp32."""

    def __init__(self, in_channels, nc=256, use_mlp=True,
                 dtype=torch.float32):
        super().__init__()
        self.use_mlp = use_mlp
        if use_mlp:
            for i, c in enumerate(in_channels):
                self.add_module(f"mlp_{i}_0", Dense(c, nc, dtype=dtype))
                self.add_module(f"mlp_{i}_1", Dense(nc, nc, dtype=dtype))

    def forward(self, feats, patch_ids):
        out = []
        for i, (feat, ids) in enumerate(zip(feats, patch_ids)):
            b, h, w, c = feat.shape
            # NHWC views of NCHW maps: gather along the flat spatial axis
            flat = feat.permute(0, 3, 1, 2).reshape(b, c, h * w)
            x = flat.index_select(2, ids).transpose(1, 2).reshape(-1, c)
            if self.use_mlp:
                x = getattr(self, f"mlp_{i}_0")(x)
                x = getattr(self, f"mlp_{i}_1")(F.relu(x))
            x = x * torch.rsqrt(torch.sum(x * x, dim=1, keepdim=True) + 1e-10)
            out.append(x.float())
        return out


def sample_patch_ids(generator, feats, num_patches):
    """One id set a layer: ``min(num_patches, H·W)`` distinct flat
    positions."""
    ids = []
    for f in feats:
        hw = f.shape[1] * f.shape[2]
        perm = torch.randperm(hw, generator=generator,
                              device=generator.device)
        ids.append(perm[:min(num_patches, hw)])
    return ids


# ----------------------------- NCE losses ---------------------------------

def _eye(n, device):
    return torch.eye(n, dtype=torch.bool, device=device)[None]


def _neg_logits(feat_q, feat_k, batch_dim):
    dim = feat_q.shape[1]
    q = feat_q.reshape(batch_dim, -1, dim)
    k = feat_k.reshape(batch_dim, -1, dim)
    npatches = q.shape[1]
    l_neg = torch.einsum("bid,bjd->bij", q, k)
    l_neg = l_neg.masked_fill(_eye(npatches, q.device), -10.0)
    return l_neg, npatches


def _nce_from_logits(l_pos, l_neg, nce_T):
    logits = torch.cat([l_pos, l_neg], dim=1) / nce_T
    return torch.logsumexp(logits, dim=1) - logits[:, 0]


def patch_nce_loss(feat_q, feat_k, nce_T=0.07, batch=1,
                   include_all_negatives=False):
    """Per-patch PatchNCE; ``feat_k`` is detached."""
    feat_k = feat_k.detach()
    bdim = 1 if include_all_negatives else batch
    l_pos = torch.sum(feat_q * feat_k, dim=1, keepdim=True)
    l_neg, npatches = _neg_logits(feat_q, feat_k, bdim)
    return _nce_from_logits(l_pos, l_neg.reshape(-1, npatches), nce_T)


def _sinkhorn(K, max_iter=50):
    n, in_size, out_size = K.shape
    a = out_size / in_size
    u = torch.ones((n, in_size), dtype=K.dtype, device=K.device)
    v = torch.ones((n, out_size), dtype=K.dtype, device=K.device)
    for _ in range(max_iter):
        u = a / (torch.einsum("bio,bo->bi", K, v) + 1e-12)
        v = 1.0 / (torch.einsum("bi,bio->bo", u, K) + 1e-12)
    return u[:, :, None] * K * v[:, None, :]


def monce_loss(feat_q, feat_k, nce_T=0.07, batch=1, num_patches=256,
               include_all_negatives=False, eps=1.0, max_iter=50):
    """MoNCE: the negatives reweighted by the Sinkhorn transport plan."""
    feat_k = feat_k.detach()
    bdim = 1 if include_all_negatives else batch
    dim = feat_q.shape[1]
    q = feat_q.reshape(bdim, -1, dim)
    k = feat_k.reshape(bdim, -1, dim)
    C = torch.einsum("bid,bod->bio", q, k)
    npatches = q.shape[1]
    K = torch.exp(C.masked_fill(_eye(npatches, q.device), -10.0) / eps)
    f = _sinkhorn(K, max_iter)
    f = f.transpose(1, 2) * (num_patches - 1) + 1e-8
    l_pos = torch.sum(feat_q * feat_k, dim=1, keepdim=True)
    l_neg, _ = _neg_logits(feat_q, feat_k, bdim)
    l_neg = l_neg + torch.log(f) * nce_T
    return _nce_from_logits(l_pos, l_neg.reshape(-1, npatches), nce_T)


def src_hdce_loss(feat_q, feat_k, nce_T=0.07, batch=1, num_patches=256,
                  include_all_negatives=False, gamma=50.0):
    """SRC (relation consistency) and hardness-weighted DCE. Returns
    (hdce, src), per patch."""
    feat_k_sg = feat_k.detach()
    bdim = 1 if include_all_negatives else batch
    dim = feat_q.shape[1]
    q = feat_q.reshape(bdim, -1, dim)
    k = feat_k_sg.reshape(bdim, -1, dim)
    npatches = q.shape[1]
    eye = _eye(npatches, q.device)
    sim_q = torch.einsum("bid,bjd->bij", q, q)
    sim_k = torch.einsum("bid,bjd->bij", k, k)
    p_q = torch.softmax(sim_q.masked_fill(eye, -1e4) / nce_T, dim=-1)
    p_k = torch.softmax(sim_k.masked_fill(eye, -1e4) / nce_T, dim=-1)
    src = torch.sum(p_k * (torch.log(p_k + 1e-8) - torch.log(p_q + 1e-8)),
                    dim=-1)
    l_neg = torch.einsum("bid,bjd->bij", q, k)
    weights = torch.softmax(l_neg.masked_fill(eye, -1e4) * gamma / dim,
                            dim=-1)
    l_neg = l_neg.masked_fill(eye, -10.0) + nce_T * torch.log(
        weights * (npatches - 1) + 1e-8)
    l_pos = torch.sum(feat_q * feat_k_sg, dim=1, keepdim=True)
    hdce = _nce_from_logits(l_pos, l_neg.reshape(-1, npatches), nce_T)
    return hdce, src.reshape(-1)


def contrastive_gan_loss(pred_true, pred_false):
    """mean_i [logsumexp(t_i, f_0..f_M) - t_i] (``cut_networks.py:
    154-164``)."""
    t = pred_true.reshape(-1).float()
    f = pred_false.reshape(-1).float()
    return torch.mean(torch.logaddexp(t, torch.logsumexp(f, 0)) - t)


# ----------------------------- GAN losses ---------------------------------

def sigmoid_ce(logits, labels):
    """optax ``sigmoid_binary_cross_entropy``'s formula."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def gan_loss(pred, target_is_real, mode="lsgan", smooth=0.0):
    """One prediction map's criterion (lsgan, vanilla, wgangp, projected
    hinge); ``smooth`` is one-sided label smoothing of real targets."""
    if mode == "lsgan":
        target = (1.0 - smooth) if target_is_real else 0.0
        return torch.mean((pred - target) ** 2)
    if mode == "vanilla":
        target = (torch.ones_like(pred) * (1.0 - smooth) if target_is_real
                  else torch.zeros_like(pred))
        return torch.mean(sigmoid_ce(pred, target))
    if mode == "wgangp":
        return -torch.mean(pred) if target_is_real else torch.mean(pred)
    if mode == "projected":
        return (torch.mean(F.relu(1.0 - pred)) if target_is_real
                else torch.mean(F.relu(1.0 + pred)))
    raise NotImplementedError(mode)


def wgangp_gradient_penalty(d_apply, real, fake, alpha, constant=1.0):
    """Mixed-interpolate gradient penalty; ``alpha`` (N, 1, 1, 1) is the
    draw the JAX function takes from its key. Differentiable (the penalty's
    own gradient reaches D)."""
    interp = alpha * real + (1 - alpha) * fake
    if not interp.requires_grad:
        interp = interp.detach().requires_grad_(True)
    grads, = torch.autograd.grad(d_apply(interp).sum(), interp,
                                 create_graph=True)
    gnorm = torch.sqrt(torch.sum(grads.reshape(grads.shape[0], -1) ** 2,
                                 dim=1) + 1e-16)
    return torch.mean((gnorm - constant) ** 2)
