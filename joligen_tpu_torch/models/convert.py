"""flax parameter tree <-> torch state dict, by tree path.

A flax leaf ``params/inner/ResBlock_5/GroupNorm32_1/GroupNorm_0/scale`` is
the torch key ``inner.ResBlock_5.GroupNorm32_1.GroupNorm_0.weight``: the
port's modules carry the flax names. Leaf mappings:

- conv ``kernel`` HWIO <-> ``weight`` OIHW;
- dense ``kernel`` (in, out) <-> ``weight`` (out, in);
- norm ``scale`` <-> ``weight``; ``bias`` <-> ``bias``;
- embedding tables (modules named ``embedder_*``) ``embedding`` <-> ``weight``.

Both directions only transpose, so they are exact.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_torch(params):
    """Nested dict of numpy arrays (optionally under a top ``params`` key)
    -> torch state dict (CPU tensors)."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf)
        name = path[-1]
        if name == "kernel" and arr.ndim == 4:
            arr, tname = arr.transpose(3, 2, 0, 1), "weight"
        elif name == "kernel" and arr.ndim == 2:
            arr, tname = arr.T, "weight"
        elif name in ("scale", "embedding"):
            tname = "weight"
        elif name == "bias":
            tname = "bias"
        else:
            raise ValueError(f"unmapped flax leaf {'/'.join(path)} "
                             f"{arr.shape}")
        out[".".join(path[:-1] + (tname,))] = torch.from_numpy(
            np.array(arr, order="C"))
    return out


def torch_to_flax(state_dict):
    """torch state dict -> ``{"params": nested dict of numpy arrays}``."""
    root = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        arr = t.detach().cpu().numpy()
        name, module = parts[-1], parts[-2]
        if name == "bias":
            fname = "bias"
        elif name != "weight":
            raise ValueError(f"unmapped torch parameter {key}")
        elif arr.ndim == 4:
            arr, fname = arr.transpose(2, 3, 1, 0), "kernel"
        elif arr.ndim == 1:
            fname = "scale"
        elif module.startswith("embedder"):
            fname = "embedding"
        else:
            arr, fname = arr.T, "kernel"
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[fname] = np.ascontiguousarray(arr)
    return {"params": root}
