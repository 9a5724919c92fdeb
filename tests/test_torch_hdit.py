"""HDiT in the port (``joligen_tpu_torch/models/modules/hdit.py``) and
palette's raw-t trunks in ``PaletteModel`` against the JAX package on the
CPU, fp32, seeded numpy inputs, seeded weights through the converter (the
zero-init layers, ``lin``, ``proj``, ``ff_out``, the mapping's ``down{i}``
and ``patch_out``, filled from a seed; the attention scales positive):

1. the RoPE angles bit for bit and ``apply_rope`` to 1e-6; the shifted
   window seam mask exactly, at several grids and shifts; the cosine-sim
   scaling to 1e-6, its logits bounded by the scale;
2. ``HDiTBlock`` forward and every gradient, to 1e-4: shifted windows,
   unshifted windows and global attention;
3. a whole small ``HDiT`` (patch 2, widths 32/64/64, depths 2/1/2, head dim
   16, window 4, 32 px: two windowed levels, an odd layer index in the
   decoder), forward and the gradients of the input and every parameter,
   to 1e-4 of the largest; the converter (``attn_scale``, the 0-D
   ``lerp{i}``) both ways bit for bit. The t embedding is the JAX
   function's, fed (``jax_embedding``): at t × 1000 the two fp32
   sinusoids differ by an ulp of their arguments (7.6e-6), which this net
   amplifies to 1e-4 (the cosine-sim attention at scale 10); with it fed,
   the port's fp32 output is 6.0e-5 from the JAX package's float64 one,
   the JAX package's fp32 output 7.2e-5;
4. one ``PaletteModel`` AdamW + EMA step with the hdit and the vit trunk
   (mask conditioning: one mask channel), the JAX keys' draws replayed,
   against the JAX model's step: the loss to 1e-4, parameters and EMA to
   2e-5 (the Adam allowance for exactly-zero gradients);
5. ``hdit`` as a GAN generator raises with its ROADMAP item;
6. the example config with ``--G_netG vit`` and ``hdit`` at full width on
   the meta device: names and shapes against ``jax.eval_shape``,
   130,487,552 and 62,901,014 parameters.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (fast_init_net_state, few_torch_threads,
                               seeded_tree)
from joligen_tpu.models import create_model as jax_create_model
from joligen_tpu.models import palette_model as jpm
from joligen_tpu.models import train_state as jts
from joligen_tpu.models.modules import hdit as jh
from joligen_tpu.options import TrainOptions as JaxTrainOptions
from joligen_tpu.parallel.mesh import quantize_batch
from joligen_tpu_torch.models import create_model
from joligen_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from joligen_tpu_torch.models.modules import hdit as th
from joligen_tpu_torch.models.modules.palette_diffusion import \
    continuous_gammas
from joligen_tpu_torch.options import TrainOptions

TOL = 1e-4
SMALL = dict(patch_size=2, widths=(32, 64, 64), depths=(2, 1, 2), d_head=16,
             window=4, out_channels=3)
B, SIZE, CIN = 2, 32, 5


def _np(t):
    return t.detach().float().numpy()


def _seeded(shapes, seed):
    """``seeded_tree`` with the attention scales drawn around their init
    (10), positive: a scale's square root is taken."""
    tree = seeded_tree(shapes, seed, 0.05, lecun=True)

    def walk(t):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "attn_scale":
                t[k] = (10.0 + 20.0 * v).astype(np.float32)
            elif k.startswith("lerp"):
                t[k] = (0.5 + v).astype(np.float32)
    walk(tree)
    return tree


@pytest.fixture
def jax_embedding(monkeypatch):
    """The port's HDiT takes the JAX package's sinusoidal t embedding."""
    from joligen_tpu.ops.schedules import timestep_embedding

    def embed(t, dim):
        return torch.from_numpy(np.array(timestep_embedding(
            jnp.asarray(t.detach().cpu().numpy()), dim)))
    monkeypatch.setattr(th, "timestep_embedding", embed)


def _grads_close(jgrads, module, tol=TOL):
    """Every parameter gradient within ``tol`` of the largest of all."""
    want = flax_to_torch(jax.device_get(jgrads))
    assert set(want) == {n for n, _ in module.named_parameters()}
    top = max(float(v.abs().max()) for v in want.values())
    for name, p in module.named_parameters():
        err = float((p.grad - want[name]).abs().max())
        assert err <= tol * top, (name, err, top)


def test_rope_tables_and_rotation_match_jax():
    for gh, gw, hd, nh in ((4, 4, 32, 2), (8, 4, 64, 3), (2, 6, 16, 4)):
        pos = jh.make_axial_pos(gh, gw)
        np.testing.assert_array_equal(th.make_axial_pos(gh, gw), pos)
        theta = jh.rope_theta(pos, hd, nh)
        np.testing.assert_array_equal(th.rope_theta(pos, hd, nh), theta)
        assert theta.shape == (gh * gw, nh, hd // 4)
        x = np.random.default_rng(gh).standard_normal(
            (2, nh, gh * gw, hd)).astype(np.float32)
        want = np.asarray(jh.apply_rope(jnp.asarray(x), theta))
        t = torch.from_numpy(theta).permute(1, 0, 2)[None]
        got = th.apply_rope(torch.from_numpy(x), torch.cos(t), torch.sin(t))
        np.testing.assert_allclose(_np(got), want, atol=1e-6)
        np.testing.assert_array_equal(_np(got)[..., hd // 2:],
                                      x[..., hd // 2:])
    # the coarse level's pixel centres are the 2x2 means of the fine one's
    np.testing.assert_allclose(
        jh.downscale_pos(jh.make_axial_pos(8, 4), 8, 4),
        th.make_axial_pos(4, 2), atol=1e-7)


@pytest.mark.parametrize("nwh,nww,wsz,shift", [(2, 2, 4, 2), (3, 2, 4, 2),
                                               (2, 4, 8, 4), (1, 3, 6, 3)])
def test_seam_mask_matches_jax(nwh, nww, wsz, shift):
    want = jh._shifted_window_mask(nwh, nww, wsz, shift)
    got = th.shifted_window_mask(nwh, nww, wsz, shift)
    assert got.dtype == bool and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert not got[0].all()
    if nwh > 1 and nww > 1:                 # an unwrapped window
        assert got[-1].all()


def test_cosine_sim_scale_matches_jax():
    rng = np.random.default_rng(0)
    q, k = (rng.standard_normal((1, 2, 8, 16)).astype(np.float32) * 100
            for _ in range(2))
    scale = np.array([10.0, 3.0], np.float32)
    want = jh.scale_for_cosine_sim(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(scale))
    got = th.scale_for_cosine_sim(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(scale))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)
    logits = torch.einsum("bhqd,bhkd->bhqk", *got)
    assert (logits.abs().amax(dim=(2, 3))
            <= torch.from_numpy(scale) * (1 + 1e-5)).all()


@pytest.mark.parametrize("window,shift", [(4, 2), (4, 0), (0, 0)])
def test_block_matches_jax_forward_and_gradients(window, shift):
    rng = np.random.default_rng(1)
    grid, d, nh = (8, 8), 32, 2
    x = rng.standard_normal((B, 64, d)).astype(np.float32)
    c = rng.standard_normal((B, 48)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jblk = jh.HDiTBlock(num_heads=nh, window=window, shift=shift, grid=grid)
    shapes = jax.eval_shape(lambda r: jblk.init(r, jnp.asarray(x),
                                                jnp.asarray(c)),
                            jax.random.PRNGKey(0))
    tree = _seeded(shapes, 2)
    want, vjp = jax.vjp(lambda p, xx, cc: jblk.apply(p, xx, cc),
                        jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                        jnp.asarray(c))
    jp, jx, jc = vjp(jnp.asarray(cot))

    tblk = th.HDiTBlock(d, 48, nh, window, shift)
    tblk.load_state_dict(flax_to_torch(tree), strict=True)
    assert float(tblk.proj.weight.detach().abs().max()) > 0
    xt, ct = (torch.from_numpy(a).requires_grad_() for a in (x, c))
    got = tblk(xt, ct, grid)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL,
                               rtol=TOL)
    got.backward(torch.from_numpy(cot))
    for g, w in ((xt.grad, jx), (ct.grad, jc)):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=TOL,
                                   rtol=TOL)
    _grads_close(jp, tblk)


@pytest.fixture(scope="module")
def hdit_pair():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (B, SIZE, SIZE, CIN)).astype(np.float32)
    t = rng.uniform(0, 1, (B,)).astype(np.float32)
    jnet = jh.HDiT(**SMALL)
    shapes = jax.eval_shape(lambda r: jnet.init(r, jnp.asarray(x),
                                                jnp.asarray(t)),
                            jax.random.PRNGKey(0))
    return jnet, _seeded(shapes, 4), x, t


def test_hdit_matches_jax_forward_and_gradients(hdit_pair, jax_embedding):
    jnet, tree, x, t = hdit_pair
    cot = np.random.default_rng(5).standard_normal(
        (B, SIZE, SIZE, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda p, xx: jnet.apply(p, xx, jnp.asarray(t)),
                        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    jp, jx = vjp(jnp.asarray(cot))

    tnet = th.HDiT(CIN, **SMALL)
    tnet.load_state_dict(flax_to_torch(tree), strict=True)
    assert [blk.shift for blk in (tnet.enc0_0, tnet.enc0_1, tnet.dec0_0,
                                  tnet.dec0_1)] == [0, 2, 0, 2]
    for leaf in (tnet.patch_out, tnet.mapping.down0, tnet.enc0_0.ff_out,
                 tnet.mid_0.attn_norm.lin):
        assert float(leaf.weight.detach().abs().max()) > 0
    xt = torch.from_numpy(x).requires_grad_()
    got = tnet(xt, torch.from_numpy(t))
    assert got.shape == (B, SIZE, SIZE, 3) and got.dtype == torch.float32
    w = np.asarray(want)
    top = float(np.abs(w).max())
    assert float(np.abs(_np(got) - w).max()) <= TOL * top
    got.backward(torch.from_numpy(cot))
    jxn = np.asarray(jx)
    assert float(np.abs(_np(xt.grad) - jxn).max()) <= TOL * float(
        np.abs(jxn).max())
    _grads_close(jp, tnet)


def test_hdit_tree_round_trips_exactly(hdit_pair):
    _, tree, _, _ = hdit_pair
    sd = flax_to_torch(tree)
    assert sd["lerp0"].shape == () and sd["enc1_0.attn_scale"].shape == (4,)
    back = torch_to_flax(sd)
    want = jax.tree_util.tree_leaves_with_path(tree)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        assert got[path].shape == leaf.shape, path
        np.testing.assert_array_equal(got[path], leaf)


# -------------------------------------------------------------------------
# PaletteModel with a raw-t trunk
# -------------------------------------------------------------------------
def _palette_cfg(tmp, netg):
    trunk = ({"hdit_widths": [32, 64], "hdit_depths": [1, 1],
              "hdit_patch_size": 2} if netg == "hdit" else
             {"vit_depth": 2, "vit_hidden_size": 64, "vit_num_heads": 2,
              "vit_patch_size": 4, "vit_bottleneck_dim": 16,
              "vit_in_context_start": 1, "vit_in_context_len": 4})
    return {
        "model_type": "palette", "name": netg, "checkpoints_dir": str(tmp),
        "data": {"crop_size": 16, "load_size": 16},
        "G": {"netG": netg, "diff_n_timestep_train": 200, **trunk},
        "alg": {"diffusion": {"task": "inpainting", "cond_embed": "mask",
                              "cond_embed_dim": 32},
                "palette": {"loss": "MSE", "minsnr": True}},
        "train": {"G_ema": True, "G_ema_beta": 0.9, "optim": "adamw",
                  "optim_weight_decay": 0.01, "n_epochs": 1,
                  "n_epochs_decay": 2},
        "tpu": {"bf16": False},
    }


def _batch(seed):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
    mask = np.zeros((B, 16, 16, 1), np.int32)
    mask[0, 2:10, 3:13] = 1
    mask[1, 6:15, 1:8] = 1
    cond = np.where(mask > 0, -1.0, gt).astype(np.float32)
    return {"A": cond, "B": gt, "B_label_mask": mask}


def _host_draws(key, sched, tm, shape):
    """The JAX ``_loss_fn``'s draws from ``key``, in its split order."""
    rng, _ = jax.random.split(key)
    rng_g, rng_n, _ = jax.random.split(rng, 3)
    rng_t, rng_u = jax.random.split(rng_g)
    t = torch.from_numpy(np.array(jax.random.randint(
        rng_t, (shape[0],), 1, sched.num_timesteps))).long()
    u = torch.from_numpy(np.array(jax.random.uniform(rng_u, (shape[0],))))
    return {"t": t, "gammas": continuous_gammas(tm.sched_train, t, u),
            "noise": torch.from_numpy(np.array(
                jax.random.normal(rng_n, shape, jnp.float32)))}


@pytest.mark.parametrize("netg", ["hdit", "vit"])
def test_palette_step_matches_jax(tmp_path, monkeypatch, jax_embedding,
                                  netg):
    cfg = _palette_cfg(tmp_path, netg)
    jopt = JaxTrainOptions().parse_json(cfg, verbose=False)
    opt = TrainOptions().parse_json(cfg, verbose=False)
    jopt.steps_per_epoch = opt.steps_per_epoch = 4
    monkeypatch.setattr(jpm, "init_net_state", fast_init_net_state(80))
    jm = jax_create_model(jopt, phase="test")
    tm = create_model(opt, phase="train", device="cpu")
    inner = tm.nets["G_A"].inner
    assert tm.nets["G_A"].raw_t and inner.patch_size * inner.patch_size * 7 \
        == (inner.patch_in if netg == "hdit" else inner.patch_bneck) \
        .weight.shape[1]
    params = jax.tree.map(np.asarray, jax.device_get(
        jm.states["G_A"].params))
    if netg == "hdit":
        params = _seeded(jax.eval_shape(lambda: params), 6)
    for net in (tm.nets["G_A"], tm.ema_nets["G_A"]):
        net.load_state_dict(flax_to_torch(params), strict=True)
    tx = jm.txs["G_A"]

    @jax.jit
    def jstep(state, key, y_cond, gt, mask):
        loss, grads = jax.value_and_grad(jm._loss_fn)(
            state.params, key, y_cond, gt, mask, None)
        return jts.apply_updates(state, grads, tx, jm.ema_beta), loss, grads

    p = jax.tree.map(jnp.asarray, params)
    js = jts.NetState(params=p, opt_state=tx.init(p),
                      ema_params=jax.tree.map(jnp.copy, p),
                      step=jnp.zeros((), jnp.int32))
    batch, key = _batch(7), jax.random.PRNGKey(8)
    inp = quantize_batch(jm.set_input(batch), float_keys=("y_cond", "gt"),
                         int_keys=("mask",))
    js, want, grads = jstep(js, key, *(jnp.asarray(inp[k]) for k in (
        "y_cond", "gt", "mask")))
    got = tm.optimize_prepared(tm.prepare_batch(batch), draws=_host_draws(
        key, jm.sched_train, tm, batch["B"].shape))
    np.testing.assert_allclose(got["G_tot"].item(), float(want), rtol=1e-4)
    g0 = flax_to_torch(jax.device_get(grads))
    top = max(g.abs().max().item() for g in g0.values())
    lr = float(opt.train_G_lr)
    host = jax.device_get(js)
    for module, tree in ((tm.nets["G_A"], host.params),
                         (tm.ema_nets["G_A"], host.ema_params)):
        want_sd = flax_to_torch(tree)
        for k, v in module.state_dict().items():
            noise = g0[k].abs() <= 1e-7 * top
            diff = (v - want_sd[k]).abs()
            assert (~noise).sum() == 0 or diff[~noise].max() <= 2e-5, k
            assert not noise.any() or diff[noise].max() <= 2 * lr, k
    moved = max((v - torch.from_numpy(np.array(flax_to_torch(params)[k])))
                .abs().max().item()
                for k, v in tm.nets["G_A"].state_dict().items())
    assert moved > 1e-4


def test_hdit_gan_generator_raises(tmp_path):
    from joligen_tpu_torch.models.gan_networks import define_G
    cfg = _palette_cfg(tmp_path, "hdit")
    cfg["model_type"] = "cut"
    opt = TrainOptions().parse_json(cfg, verbose=False)
    with pytest.raises(NotImplementedError, match="item 13"):
        define_G(opt)


def _flax_shapes(state_dict):
    """The flax path and shape of every leaf of a (meta) state dict: a
    weight is a scale (1-D) or a transposed kernel, the blocks of a JiT
    stack stacked again."""
    out = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        name, shape = parts[-1], tuple(t.shape)
        if name == "weight":
            name, shape = (("scale", shape) if len(shape) == 1
                           else ("kernel", shape[::-1]))
        if len(parts) > 2 and parts[1] in ("blocks_pre", "blocks_post"):
            path = "/".join(parts[:2] + ["block"] + parts[3:-1] + [name])
            depth = out.get(path, (0,))[0]
            out[path] = (max(depth, int(parts[2]) + 1),) + shape
        else:
            out["/".join(parts[:-1] + [name])] = shape
    return out


@pytest.mark.parametrize("netg,count", [("vit", 130_487_552),
                                        ("hdit", 62_901_014)])
def test_palette_full_width_trees_match_jax(netg, count):
    """The example config with ``--G_netG vit`` or ``hdit`` at 128 px (the
    smoke's palette_vit_128 and palette_hdit_128): every leaf's name and
    shape against ``jax.eval_shape`` of the JAX denoiser (one mask
    channel: 7 inputs), and the parameter count the smoke asserts."""
    from joligen_tpu.models.diffusion_networks import define_G as jdefine
    from joligen_tpu_torch.models.diffusion_networks import define_G
    example = ["--config_json", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "examples", "example_ddpm_noglasses2glasses.json"), "--G_netG", netg]
    jnet = jdefine(JaxTrainOptions().parse_cli(example))
    shapes = jax.eval_shape(lambda r: jnet.init(
        r, jnp.zeros((1, 128, 128, 6)), jnp.zeros((1,)),
        cls=jnp.zeros((1,), jnp.int32),
        mask=jnp.zeros((1, 128, 128, 1), jnp.int32)), jax.random.PRNGKey(0))
    want = {"/".join(str(p.key) for p in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                shapes["params"])}
    with torch.device("meta"):
        tnet = define_G(TrainOptions().parse_cli(example))
    assert _flax_shapes(tnet.state_dict()) == want
    n = sum(p.numel() for p in tnet.parameters())
    assert n == sum(int(np.prod(s)) for s in want.values()) == count
    assert tnet.raw_t and set(shapes["params"]) == {"inner"}
