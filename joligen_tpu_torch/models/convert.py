"""flax parameter tree <-> torch state dict, by tree path.

A flax leaf ``params/inner/ResBlock_5/GroupNorm32_1/GroupNorm_0/scale`` is
the torch key ``inner.ResBlock_5.GroupNorm32_1.GroupNorm_0.weight``: the
port's modules carry the flax names. Leaf mappings:

- conv ``kernel`` HWIO <-> ``weight`` OIHW (3-D: DHWIO <-> OIDHW);
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

The JiT video denoiser (``vit_vid``) adds two rules:

- scanned stacks: the JAX package stacks the blocks of each segment with
  ``nn.scan`` (``SCAN_STACK``: a module ``blocks0``, ``blocks1``, ...,
  ``blocks_pre`` or ``blocks_post`` holding ``block``), so each leaf under
  it carries a leading depth axis: ``blocks1/block/qkv/kernel`` (8, 768,
  2304) is the per-block torch keys ``blocks1.0.qkv.weight`` ...
  ``blocks1.7.qkv.weight``, each then mapped as any leaf (a Dense
  transposed); back, the blocks' leaves stack again in block order;
- its raw tables (``y_embed``, ``register_tokens``, ``in_context_posemb``,
  the global context's ``gc_posemb`` and ``gc_type`` and the object
  references' ``oref_posemb`` and ``oref_type``: ``RAW_LEAVES``), as they
  are, under their own names, at the top of the tree. The context encoder
  ``gc_enc`` (convs, GroupNorms, Denses) and the patch embeddings
  ``gc_embed`` and ``oref_embed`` (Denses) take the rules above.

The video denoiser's motion modules need no other rule: their Dense kernels
(the bias-free ``to_q``/``to_k``/``to_v`` have no ``bias`` leaf) transpose,
their LayerNorm ``scale`` is a 1-D ``weight``, and the position table is a
buffer outside the state dict.

The GAN trees need no other rule: a depthwise kernel (``feature_group_count``
= C, HWIO with I = 1) is the OIHW weight with I = 1; ``TorchConvTranspose``
keeps its kernel as the flipped direct-conv kernel the JAX package stores,
so it transposes as any conv (and is not flipped again); spectral
normalisation keeps no state (``SNConv`` is ``kernel`` and ``bias``); the
projected D's frozen trunk and projections are plain convs and GroupNorms.

HDiT adds its per-head ``attn_scale`` (1-D) and the skips' 0-D ``lerp{i}``,
as they are (``RAW_LEAVES``, ``RAW_LEAF``). The temporal projected D adds
its LSTM cells' ``lstm_w{i}`` (2c, 4c), applied as ``[h, x] @ W``, and
``lstm_b{i}`` (4c), as they are (``RAW_LEAF``).

The rest of the GAN zoo adds raw leaves, as they are, under their own
names (``RAW_LEAVES``): UViT's attention ``qkv_kernel`` (3C, C) and
``proj_kernel`` (C, C), already (out, in) and applied as ``W @ x``, so not
a Dense and not transposed, with ``qkv_bias`` and ``proj_bias``; HAT's
relative-position bias tables ``rpb`` ((2w - 1)² or (w + ow - 1)², heads);
ITTR's ``ChanLayerNorm`` gain ``g`` and bias ``b``. ITTR's transposed convs
are ``TorchConvTranspose``, above; HAT's LayerNorms are ``scale`` and
``bias``.

The LoRA adapter tree (``models/lora.py``) is keyed by the flax path of the
kernel it adapts, as flax's ``to_state_dict`` writes a dict with tuple keys
(``"('blocks_pre', 'block', 'qkv', 'kernel')"``), each an ``a`` (d_in, r)
and a ``b`` (r, d_out), stacked like the kernel: ``lora_to_flax`` and
``lora_from_flax`` carry it as it is; ``flax_kernel_path`` names a torch
Dense weight's kernel in that tree.

MAT's trees (``weight_leaves``; its nets set ``flax_weight_leaves``) name
their leaves ``weight`` in flax too: a conv ``weight`` HWIO <-> OIHW, a
dense ``weight`` (in, out) <-> (out, in), and the 0-D ``noise_strength`` as
it is. No other tree has a flax ``weight``, and without the flag the
mapping of every other tree is as above. The video generator's ``motion``
subtree (``MAT_KERNEL_SUBTREES``) is a flax ``MotionModule`` of ``kernel``,
``scale`` and ``bias`` leaves: it takes the rules above, not MAT's, in both
directions (its torch ``weight``s would otherwise pass for MAT's).

The metric networks (``utils/metrics.py``, ``inception.py``, ``i3d.py``)
need no other rule: their convs and denses map as above, I3D's 3-D kernels
too, and I3D's flat ``<block>.<branch>`` unit names are the state-dict
keys of its branches (``I3D.flax_tree`` joins them again on the way back).

Both directions only transpose, so they are exact. The same mapping carries
an optax adam/adamw state (count, mu, nu) to the port's optimizer state and
back, and the state of radam, lion, muon and the JAX package's madgrad to
the port's (``optax_state_to_torch``). ``flax_layout`` names a torch
parameter's flax leaf (Muon picks its leaves by their flax rank).
"""

from __future__ import annotations

import ast
import re

import numpy as np
import torch

RAW_LEAVES = ("W", "class_embedding", "positional_embedding", "proj",
              "cls_token", "pos_embed", "ls1", "ls2", "y_embed",
              "register_tokens", "in_context_posemb", "gc_posemb",
              "gc_type", "oref_posemb", "oref_type", "attn_scale",
              "qkv_kernel", "qkv_bias", "proj_kernel", "proj_bias", "rpb",
              "g", "b")
RAW_LEAF = re.compile(r"(lerp|lstm_w|lstm_b)\d+$")
# a module whose child ``block`` is an ``nn.scan`` stack of blocks
SCAN_STACK = re.compile(r"blocks(\d+|_pre|_post)$")
# the top-level subtrees of a MAT tree that keep the ``kernel`` rules
MAT_KERNEL_SUBTREES = ("motion",)


def _mat_leaf(weight_leaves, path, name):
    """Whether a leaf named ``name`` at ``path`` takes MAT's rule."""
    return (weight_leaves and name in ("weight", "noise_strength")
            and path[0] not in MAT_KERNEL_SUBTREES)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unstack(path, arr):
    """(path, leaf) of one flax leaf, or one per block where the path runs
    through a scanned stack (``SCAN_STACK``/``block``): the stack's index
    replaces ``block`` and the leading depth axis goes."""
    for i in range(len(path) - 1):
        if SCAN_STACK.match(path[i]) and path[i + 1] == "block":
            for j in range(arr.shape[0]):
                yield from _unstack(path[:i + 1] + (str(j),) + path[i + 2:],
                                    arr[j])
            return
    yield path, arr


def flax_to_torch(params, weight_leaves=False):
    """Nested dict of numpy arrays (optionally under a top ``params`` key)
    -> torch state dict (CPU tensors). ``weight_leaves``: MAT's rule."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, arr in (pair for p, leaf in _flatten(params)
                      for pair in _unstack(p, np.asarray(leaf))):
        name = path[-1]
        if _mat_leaf(weight_leaves, path, name):
            tname = name
            if name == "weight" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif name == "weight" and arr.ndim == 2:
                arr = arr.T
            elif name == "weight" or arr.ndim != 0:
                raise ValueError(f"unmapped flax leaf {'/'.join(path)} "
                                 f"{arr.shape}")
        elif name == "kernel" and arr.ndim == 4:
            arr, tname = arr.transpose(3, 2, 0, 1), "weight"
        elif name == "kernel" and arr.ndim == 5:
            arr, tname = arr.transpose(4, 3, 0, 1, 2), "weight"
        elif name == "kernel" and arr.ndim == 2:
            arr, tname = arr.T, "weight"
        elif name in ("scale", "embedding"):
            tname = "weight"
        elif name == "bias" or name in RAW_LEAVES or RAW_LEAF.match(name) \
                or (name == "kernel" and arr.ndim == 3):
            tname = name
        else:
            raise ValueError(f"unmapped flax leaf {'/'.join(path)} "
                             f"{arr.shape}")
        out[".".join(path[:-1] + (tname,))] = torch.from_numpy(
            np.array(arr, order="C"))
    return out


def _tree_to_torch_numpy(tree, weight_leaves=False):
    """A flax-shaped tree (any float dtype, bf16 included) -> numpy fp32
    arrays keyed and laid out like the torch parameters."""
    def f32(t):
        return {k: f32(v) if isinstance(v, dict) else np.asarray(v, np.float32)
                for k, v in t.items()}
    return {k: v.numpy() for k, v in
            flax_to_torch(f32(tree), weight_leaves).items()}


def _masked(v):
    return type(v).__name__ == "MaskedNode"


def _unmasked(tree):
    """``tree`` without optax's ``MaskedNode`` leaves (and the dicts they
    leave empty)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _unmasked(v)
            if v:
                out[k] = v
        elif not _masked(v):
            out[k] = v
    return out


def optax_state_to_torch(opt_state, weight_leaves=False):
    """An optax state of the JAX ``make_optimizer`` -> the port's optimizer
    state dict (``models/train_state.py``), reading the NamedTuples by field
    name (optax is not imported): adam, adamw and radam (the ``chain``
    holding ``ScaleByAdamState``) -> {"count", "mu", "nu"}; lion
    (``ScaleByLionState``) -> {"count", "mu"}; the JAX package's madgrad
    dict {"s", "v", "x0", "k"} -> {"count", "s", "v", "x0"}; muon (the
    ``PartitionState`` of its ``muon`` and ``adam`` branches, each leaf of
    one a ``MaskedNode`` in the other) -> {"count", "mu", "adam"}; each in
    {"mini_step", "gradient_step", "acc_grads", "inner"} under
    ``MultiStepsState``."""
    tree = lambda t: _tree_to_torch_numpy(_unmasked(t), weight_leaves)
    if hasattr(opt_state, "mini_step"):
        return {"mini_step": int(opt_state.mini_step),
                "gradient_step": int(opt_state.gradient_step),
                "acc_grads": tree(opt_state.acc_grads),
                "inner": optax_state_to_torch(opt_state.inner_opt_state,
                                              weight_leaves)}
    if isinstance(opt_state, dict) and "x0" in opt_state:
        return {"count": int(opt_state["k"]), "s": tree(opt_state["s"]),
                "v": tree(opt_state["v"]), "x0": tree(opt_state["x0"])}
    if hasattr(opt_state, "inner_states"):
        branches = dict(opt_state.inner_states)
        muon = next(s for s in branches["muon"].inner_state
                    if hasattr(s, "ns_coeffs"))
        return {"count": int(muon.count), "mu": tree(muon.mu),
                "adam": optax_state_to_torch(
                    branches["adam"].inner_state, weight_leaves)}
    first = next(s for s in opt_state if hasattr(s, "mu"))
    out = {"count": int(first.count), "mu": tree(first.mu)}
    if hasattr(first, "nu"):
        out["nu"] = tree(first.nu)
    return out


def torch_adam_state_to_optax(state, template, weight_leaves=False):
    """Inverse of ``optax_state_to_torch`` for adam and adamw: fills a
    copy of ``template`` (the optimizer's own ``init`` state, which gives
    the NamedTuple types and the leaf dtypes) from the port's state
    dict."""
    def tree(arrays, like):
        flax = torch_to_flax({k: torch.from_numpy(np.asarray(v, np.float32))
                              for k, v in arrays.items()}, weight_leaves)
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
                state["inner"], template.inner_opt_state, weight_leaves))
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


def torch_to_flax(state_dict, weight_leaves=False):
    """torch state dict -> ``{"params": nested dict of numpy arrays}``.
    ``weight_leaves``: MAT's rule."""
    root = {}
    stacks = {}     # path with ``block`` -> {block index: leaf}
    for key, t in state_dict.items():
        parts = key.split(".")
        t = t.detach()
        name, module = parts[-1], parts[-2] if len(parts) > 1 else ""
        perm = None         # the leaf's axes in flax's order, if moved
        if _mat_leaf(weight_leaves, parts, name):
            fname = name
            if name == "weight" and t.dim() == 4:
                perm = (2, 3, 1, 0)
            elif name == "weight" and t.dim() == 2:
                perm = (1, 0)
            elif name == "weight" or t.dim() != 0:
                raise ValueError(f"unmapped torch parameter {key}")
        elif name in ("bias", "kernel") or name in RAW_LEAVES \
                or RAW_LEAF.match(name):
            fname = name
        elif name != "weight":
            raise ValueError(f"unmapped torch parameter {key}")
        elif t.dim() == 4:
            perm, fname = (2, 3, 1, 0), "kernel"
        elif t.dim() == 5:
            perm, fname = (2, 3, 4, 1, 0), "kernel"
        elif t.dim() == 1:
            fname = "scale"
        elif module.startswith("embedder"):
            fname = "embedding"
        else:
            perm, fname = tuple(reversed(range(t.dim()))), "kernel"
        # the axes move where the tensor lies (on the card, before its one
        # copy to the host)
        if perm is not None and t.dim() > 1:
            t = t.permute(perm).contiguous()
        arr = t.cpu().numpy()
        path = parts[:-1] + [fname]
        for i in range(len(path) - 1):
            if SCAN_STACK.match(path[i]) and path[i + 1].isdigit():
                stack = tuple(path[:i + 1] + ["block"] + path[i + 2:])
                stacks.setdefault(stack, {})[int(path[i + 1])] = arr
                break
        else:
            _set(root, path, np.asarray(arr, order="C"))   # keeps 0-D
    for path, blocks in stacks.items():
        _set(root, list(path),
             np.stack([blocks[j] for j in range(len(blocks))]))
    return {"params": root}


def _set(root, path, arr):
    node = root
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = arr


def flax_layout(name, ndim):
    """Where a torch parameter lies in the flax tree (``torch_to_flax``'s
    rules): (the flax path of its leaf, its index in a scanned stack or
    None, whether the flax leaf is its transpose: a Dense weight)."""
    parts = name.split(".")
    leaf, module = parts[-1], parts[-2] if len(parts) > 1 else ""
    transposed = False
    if leaf != "weight" or leaf in RAW_LEAVES:   # as they are (MAT's too)
        fname = leaf
    elif ndim in (4, 5):
        fname = "kernel"
    elif ndim == 1:
        fname = "scale"
    elif module.startswith("embedder"):
        fname = "embedding"
    else:
        fname, transposed = "kernel", ndim == 2
    path = parts[:-1] + [fname]
    for i in range(len(path) - 1):
        if SCAN_STACK.match(path[i]) and path[i + 1].isdigit():
            return (tuple(path[:i + 1] + ["block"] + path[i + 2:]),
                    int(path[i + 1]), transposed)
    return tuple(path), None, transposed


def flax_kernel_path(weight_name):
    """A torch Dense weight (``blocks_pre.3.qkv.weight``) -> (the flax path
    of its kernel, ``('blocks_pre', 'block', 'qkv', 'kernel')``, and its
    index in a scanned stack, or None outside one)."""
    path = weight_name.split(".")[:-1] + ["kernel"]
    for i in range(len(path) - 1):
        if SCAN_STACK.match(path[i]) and path[i + 1].isdigit():
            return (tuple(path[:i + 1] + ["block"] + path[i + 2:]),
                    int(path[i + 1]))
    return tuple(path), None


def lora_to_flax(adapters):
    """{flax path tuple: (a, b) tensors} -> the JAX package's adapter tree
    ({str(path): {"a", "b"}} of numpy arrays), as they are."""
    return {str(tuple(path)): {"a": a.detach().cpu().numpy(),
                               "b": b.detach().cpu().numpy()}
            for path, (a, b) in adapters.items()}


def lora_from_flax(tree):
    """Inverse of ``lora_to_flax``: {flax path tuple: (a, b) tensors}."""
    return {tuple(ast.literal_eval(key)): (
        torch.from_numpy(np.array(ab["a"], order="C")),
        torch.from_numpy(np.array(ab["b"], order="C")))
        for key, ab in tree.items()}
