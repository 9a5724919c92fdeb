"""CUT's semantic-mask branch with the vision-aided discriminator against
the JAX package, on the CPU:

1. ``UNetSegmenter`` (nf 16, 32 px): the logits, the input's and every
   parameter's gradient of a random cotangent to 1e-4 of their largest in
   fp32; the logits in bf16 to 2e-2 of their L2 norm.
2. A 3-step trajectory of ``CUTModel.optimize_prepared`` against the JAX
   step (``_make_step``) in fp32, on ``example_gan_noglasses2glasses.json``
   at a small width (ngf 8, 2 blocks, ndf 8, 32 px, batch 2, 16 patches,
   f_s nf 16; the basic and vision-aided Ds, the towers shrunk to dim 64,
   depth 2 in both packages) with seeded weights, the same batches (label
   masks of A and B) and the JAX step's draws fed. ``f_s_semantic_threshold``
   is raised to 10 so that the gate opens and G's semantic terms count (at
   the config's 1.0 the two-class f_s loss of about 1.4 keeps it shut).
   Here as the config stands (adam, ``train_mask_f_s_B``, the L1 out-mask
   loss, G EMA); ``tests/test_torch_glasses_cut_options.py`` runs the rest
   of the branch (adamw with weight decay, ``train_sem_idt``, disjoint
   segmenters, class weights, ``train_sem_net_output``, the Charbonnier
   out-mask loss). The helpers are in ``tests/_torch_glasses_common.py``.
   After every
   step: every loss to 1e-4 (relative) and the pool to 1e-3, from the
   state the two packages share before the step (the port set to the JAX
   step's state: params, EMA, optimizer state, pool); on the port's own
   run, never resynced, every parameter of every net to 1e-4 with the Adam
   allowance of ``tests/test_torch_gan_cut.py`` (at most 1 % of a leaf's
   elements past 1e-4, by at most 2 × lr a step). The towers' parameters: bit for bit as they started under
   adam; under adamw decayed, as in the JAX step, to 1e-6.
3. Before the trajectory: G's gradient of its whole loss (the semantic
   terms through f_s included) against ``jax.grad`` of the JAX
   ``_g_loss``.
4. The vision-aided D gives G no gradient, in either package: its GAN term
   alone reaches no G parameter (a reference property the port copies; its
   value still counts in ``G_GAN``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import (err_and_scale, few_torch_threads, grads_close,
                               load_flax, seeded_tree, to_np)
# small_towers and fast_jax_init: fixtures
from _torch_glasses_common import (SIZE, check_g_gradient, fast_jax_init,
                                   g_loss_inputs, models, run_trajectory,
                                   small_towers)
from joligen_tpu.models.modules import semantic_networks as jsem
from joligen_tpu_torch.models.modules import semantic_networks as tsem


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_unet_segmenter_matches_jax(dt):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    jnet = jsem.UNetSegmenter(nclasses=2, nf=16, dtype=jdt)
    tree = seeded_tree(jax.eval_shape(lambda r: jnet.init(
        r, jnp.asarray(x)), jax.random.PRNGKey(0)), 2, 0.1)
    params = jax.tree.map(jnp.asarray, tree)
    tnet = load_flax(tsem.UNetSegmenter(3, 2, nf=16, dtype=tdt), tree)
    assert sorted(n for n, _ in tnet.named_children()) == sorted(
        tree["params"])
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tnet(xt)
    cot = rng.standard_normal(got.shape).astype(np.float32)

    @jax.jit
    def forward_and_vjp(p, a, c):
        out, vjp = jax.vjp(jnet.apply, p, a)
        return out, vjp(c)

    want, (jgrads, jx) = forward_and_vjp(params, jnp.asarray(x),
                                         jnp.asarray(cot))
    assert got.dtype == torch.float32 and got.shape == want.shape == (
        2, SIZE, SIZE, 2)
    err, scale = err_and_scale(to_np(got), want, norm=dt == "bf16")
    assert err <= (2e-2 if dt == "bf16" else 1e-4) * scale, (err, scale)
    if dt == "bf16":
        return
    got.backward(torch.from_numpy(cot))
    err, scale = err_and_scale(to_np(xt.grad), jx, norm=False)
    assert err <= 1e-4 * scale
    grads_close(jgrads, tnet, 1e-4, 1e-6)


def test_glasses_trajectory_matches_jax_step(tmp_path, small_towers,
                                             fast_jax_init):
    jm, tm = models(tmp_path)
    assert tm.mask_f_s_B and tm.out_mask and tm.semantic_mask
    assert not (tm.sem_idt or tm.disjoint_f_s or jm.sem_idt
                or jm.disjoint_f_s)
    check_g_gradient(jm, tm)
    run_trajectory(jm, tm, adamw=False)


def test_vision_aided_d_gives_g_no_gradient(tmp_path, small_towers,
                                            fast_jax_init):
    jm, tm = models(tmp_path)
    inp, t = g_loss_inputs(jm)
    netG, netD = tm.nets["G_A"], tm.nets["D_B_vision_aided"]
    jD = jm.netDs["D_B_vision_aided"]
    term = -netD(netG(t["real_A"])).mean()
    assert term.requires_grad and term.abs() > 0
    gs = torch.autograd.grad(term, list(netG.parameters()),
                             allow_unused=True)
    assert all(g is None or not g.any() for g in gs)
    jz = jax.jit(jax.grad(lambda pG: -jnp.mean(jD.apply(
        jm.states["D_B_vision_aided"].params,
        jm.netG.apply(pG, inp["real_A"])))))(jm.states["G_A"].params)
    assert not any(np.asarray(v).any() for v in jax.tree.leaves(jz))
