"""flax parameter tree <-> torch state dict, by tree path.

A flax leaf ``params/inner/ResBlock_5/GroupNorm32_1/GroupNorm_0/scale`` is
the torch key ``inner.ResBlock_5.GroupNorm32_1.GroupNorm_0.weight``: the
port's modules carry the flax names. Leaf mappings:

- conv ``kernel`` HWIO <-> ``weight`` OIHW;
- dense ``kernel`` (in, out) <-> ``weight`` (out, in);
- norm ``scale`` <-> ``weight``; ``bias`` <-> ``bias``;
- embedding tables (modules named ``embedder_*``) ``embedding`` <-> ``weight``;
- the consistency model's Fourier features ``sigma_embed/W`` (1-D) <-> ``W``,
  as they are;
- the ViT towers' raw leaves (``RAW_LEAVES``: CLIP's ``class_embedding``,
  ``positional_embedding`` and its output projection ``proj`` (D, 512),
  applied as ``out @ proj``, so not a Dense and not transposed; DINOv2's
  ``cls_token``, ``pos_embed`` and LayerScales ``ls1``/``ls2``) and the
  attention's ``DenseGeneral`` kernels (rank 3: (D, H, hd), (H, hd, D)),
  as they are, under their own names.

The GAN trees need no other rule: a depthwise kernel (``feature_group_count``
= C, HWIO with I = 1) is the OIHW weight with I = 1; ``TorchConvTranspose``
keeps its kernel as the flipped direct-conv kernel the JAX package stores,
so it transposes as any conv (and is not flipped again); spectral
normalisation keeps no state (``SNConv`` is ``kernel`` and ``bias``); the
projected D's frozen trunk and projections are plain convs and GroupNorms.

Both directions only transpose, so they are exact. The same mapping carries
an optax adam/adamw state (count, mu, nu) to the port's optimizer state and
back.
"""

from __future__ import annotations

import numpy as np
import torch

RAW_LEAVES = ("W", "class_embedding", "positional_embedding", "proj",
              "cls_token", "pos_embed", "ls1", "ls2")


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
        elif name == "bias" or name in RAW_LEAVES or (
                name == "kernel" and arr.ndim == 3):
            tname = name
        else:
            raise ValueError(f"unmapped flax leaf {'/'.join(path)} "
                             f"{arr.shape}")
        out[".".join(path[:-1] + (tname,))] = torch.from_numpy(
            np.array(arr, order="C"))
    return out


def _tree_to_torch_numpy(tree):
    """A flax-shaped tree (any float dtype, bf16 included) -> numpy fp32
    arrays keyed and laid out like the torch parameters."""
    def f32(t):
        return {k: f32(v) if isinstance(v, dict) else np.asarray(v, np.float32)
                for k, v in t.items()}
    return {k: v.numpy() for k, v in flax_to_torch(f32(tree)).items()}


def optax_adam_state_to_torch(opt_state):
    """An optax adam/adamw state (the ``chain`` tuple, optionally inside
    ``MultiStepsState``) -> the port's optimizer state dict
    (``models/train_state.py``): ``{"count", "mu", "nu"}``, or
    ``{"mini_step", "gradient_step", "acc_grads", "inner"}`` around it.
    Reads the NamedTuples by field name; optax is not imported."""
    if hasattr(opt_state, "mini_step"):
        return {"mini_step": int(opt_state.mini_step),
                "gradient_step": int(opt_state.gradient_step),
                "acc_grads": _tree_to_torch_numpy(opt_state.acc_grads),
                "inner": optax_adam_state_to_torch(opt_state.inner_opt_state)}
    adam = next(s for s in opt_state if hasattr(s, "mu"))
    return {"count": int(adam.count),
            "mu": _tree_to_torch_numpy(adam.mu),
            "nu": _tree_to_torch_numpy(adam.nu)}


def torch_adam_state_to_optax(state, template):
    """Inverse of ``optax_adam_state_to_torch``: fills a copy of
    ``template`` (the optimizer's own ``init`` state, which gives the
    NamedTuple types and the leaf dtypes) from the port's state dict."""
    def tree(arrays, like):
        flax = torch_to_flax({k: torch.from_numpy(np.asarray(v, np.float32))
                              for k, v in arrays.items()})
        if "params" not in like:
            flax = flax["params"]

        def cast(t, ref):
            return {k: cast(v, ref[k]) if isinstance(v, dict)
                    else np.asarray(v).astype(np.asarray(ref[k]).dtype)
                    for k, v in t.items()}
        return cast(flax, like)

    def count(ref, value):
        return np.asarray(value, dtype=np.asarray(ref).dtype)

    if hasattr(template, "mini_step"):
        return template._replace(
            mini_step=count(template.mini_step, state["mini_step"]),
            gradient_step=count(template.gradient_step,
                                state["gradient_step"]),
            acc_grads=tree(state["acc_grads"], template.acc_grads),
            inner_opt_state=torch_adam_state_to_optax(
                state["inner"], template.inner_opt_state))
    out = []
    for s in template:
        if hasattr(s, "mu"):
            s = s._replace(count=count(s.count, state["count"]),
                           mu=tree(state["mu"], s.mu),
                           nu=tree(state["nu"], s.nu))
        elif "count" in getattr(s, "_fields", ()):   # the schedule's count
            s = s._replace(count=count(s.count, state["count"]))
        out.append(s)
    return type(template)(out)


def torch_to_flax(state_dict):
    """torch state dict -> ``{"params": nested dict of numpy arrays}``."""
    root = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        arr = t.detach().cpu().numpy()
        name, module = parts[-1], parts[-2]
        if name in ("bias", "kernel") or name in RAW_LEAVES:
            fname = name
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
