"""The CUT G loss of ``tests/test_torch_cut_zoo.py`` with the ``unet_256``,
``hdit`` and ``hat`` generators; its own file, so the JAX losses compile
in parallel workers."""

import pytest

# few_torch_threads: an autouse fixture, active once imported
from _torch_gan_common import few_torch_threads  # noqa: F401
from test_torch_cut_zoo import _models, check_g_loss


@pytest.mark.parametrize("netg", ["unet_256", "hdit", "hat"])
def test_cut_g_loss_with_more_generators_matches_jax(tmp_path, monkeypatch,
                                                     netg):
    check_g_loss(*_models(tmp_path, monkeypatch, netg))
