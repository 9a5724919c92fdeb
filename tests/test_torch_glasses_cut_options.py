"""The rest of CUT's semantic-mask branch against the JAX step, on the CPU:
the 3-step trajectory of ``tests/test_torch_glasses_cut.py`` (the same
small noglasses2glasses, the same checks) with adamw and weight decay (the
frozen towers decay, as in optax's step, and are held to the JAX step's to
1e-6), ``train_sem_idt`` (G's identity term through f_s_B),
``train_mask_disjoint_f_s`` (two segmenters, each with its own Adam),
``f_s_class_weights`` (torch's weighted cross-entropy),
``train_sem_net_output`` (f_s's own prediction as the target) and the
Charbonnier out-mask loss.
"""

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads
# small_towers and fast_jax_init: fixtures
from _torch_glasses_common import (fast_jax_init, models, run_trajectory,
                                   small_towers)

OPTIONS = {
    "train": {"optim": "adamw", "optim_weight_decay": 0.05, "G_ema": False,
              "sem": {"idt": True, "net_output": True},
              "mask": {"disjoint_f_s": True, "loss_out_mask": "Charbonnier"}},
    "f_s": {"class_weights": [1, 3]}}


def test_glasses_options_trajectory_matches_jax_step(tmp_path, small_towers,
                                                     fast_jax_init):
    jm, tm = models(tmp_path, OPTIONS)
    for m in (jm, tm):
        assert m.sem_idt and m.disjoint_f_s and m.sem_net_output
        assert m.out_mask_loss == "Charbonnier" and m.fs_weights == [1, 3]
    assert set(tm.nets) >= {"f_s", "f_s_B"}
    run_trajectory(jm, tm, adamw=True)
