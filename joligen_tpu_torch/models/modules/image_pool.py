"""The historical fake pool (``joligen_tpu/models/modules/image_pool.py``),
on the device: a (P, ...) buffer of images (the CUT model keeps NHWC) and a
fill count. Until it is full a
query inserts and returns the current fakes; then each fake is returned as
it is with probability 0.5, and otherwise swapped with (and the pool entry
returned in its place) a random entry.

The draws are explicit (``draw_query``: ``u`` (B,) uniforms and ``idx``
(B,) ints in [0, P)), so a test can feed the JAX pool's draws. The fill
count is known on the host: a query never reads the device.
"""

from __future__ import annotations

import torch


class ImagePool:
    def __init__(self, pool_size, shape, device):
        self.pool_size = int(pool_size)
        self.buffer = torch.zeros((self.pool_size,) + tuple(shape),
                                  device=device)
        self.count = 0

    def draw_query(self, generator, batch):
        dev = self.buffer.device
        return {"u": torch.rand((batch,), generator=generator, device=dev),
                "idx": torch.randint(0, max(self.pool_size, 1), (batch,),
                                     generator=generator, device=dev)}

    @torch.no_grad()
    def query(self, fakes, draws):
        """Updates the pool; returns the images for D. fakes: (B, ...)."""
        if self.pool_size == 0:
            return fakes
        b, p = fakes.shape[0], self.pool_size
        dev = fakes.device
        use_current = draws["u"] < 0.5
        pos = self.count + torch.arange(b, device=dev)
        filling = pos < p
        target = torch.where(filling, pos % p, draws["idx"])
        do_write = filling | ~use_current
        old = self.buffer.index_select(0, target)
        bcast = (b,) + (1,) * (fakes.ndim - 1)
        returned = torch.where((filling | use_current).reshape(bcast), fakes,
                               old)
        write = torch.where(do_write.reshape(bcast), fakes, old)
        self.buffer.index_put_((target,), write)
        self.count = min(self.count + b, p)
        return returned

    def get_random(self, idx):
        """Pool entries ``idx``, ints in [0, max(count, 1)) (APA's pseudo
        reals)."""
        return self.buffer.index_select(0, idx)
