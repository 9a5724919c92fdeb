"""Every gradient of VGG16-FCN8s under the ``fcn`` pad (99 px pad, VALID
``fc6``, crops at 5, 9 and 31) against the JAX package's, on the CPU, at
7 px (the trunk runs at 205 px) on the seeded tree of
``tests/test_torch_vgg_fcn8s.py``: the
parameters' and the input's, to 1e-4 of each leaf's largest, in float64 on
both sides (``_torch_mat_common.grads64``). In fp32 the pad's constant
border makes near-ties in the max pools, which rounding breaks differently
in the two packages, each a valid gradient; in float64 both take the
same. XLA's float64 convolutions over the trunk take most of this file's
time.
"""

import jax.numpy as jnp

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads, load_flax  # noqa: F401
from joligen_tpu.models.modules import semantic_networks as jsem
from joligen_tpu_torch.models.modules import semantic_networks as tsem
from test_torch_vgg_fcn8s import NCLASSES, _x, check_grads, vgg_tree


def test_vgg_fcn8s_fcn_gradients_match_jax():
    tree = vgg_tree()
    jmod = jsem.VGG16FCN8s(nclasses=NCLASSES, pad="fcn")
    tmod = load_flax(tsem.VGG16FCN8s(3, NCLASSES, pad="fcn"), tree)
    check_grads(jmod, tmod, tree, _x(7, 7), float64=True)
    assert jmod.clone(dtype=jnp.float64).dtype == jnp.float64
