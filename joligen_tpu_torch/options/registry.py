"""Option system: prefix-namespaced flags with CLI <-> nested-JSON bijection.

Mirrors the public option surface of the reference framework (see
reference options/base_options.py:36-325, options/common_options.py,
options/train_options.py and the per-model ``modify_commandline_options``
plugins) so that reference ``examples/*.json`` configs load unchanged.

The flag registry (names, types, defaults, choices) is stored in
``reference_schema.json`` (generated by ``tools/extract_option_schema.py``)
plus TPU-specific additions declared here.  Nested JSON keys are joined by
``_`` to produce flat flag names (reference util/util.py:317 flatten_json);
the reverse mapping uses a fixed section template (reference
options/common_options.py:18-56).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from types import SimpleNamespace

_HERE = os.path.dirname(__file__)

MAX_INT = 1000000000

# Section template controlling flat->nested conversion. Matches reference
# options/common_options.py:18-56 (with alg subsections for the diffusion
# family models, which the reference nests via their json configs).
SCHEMA_TEMPLATE = {
    "D": {},
    "G": {},
    "alg": {
        "gan": {},
        "cut": {},
        "cyclegan": {},
        "mat": {},
        "re": {},
        "palette": {},
        "diffusion": {},
        "cm": {},
        "sc": {},
        "b2b": {},
    },
    "data": {"online_creation": {}},
    "f_s": {},
    "cls": {},
    "output": {"display": {}},
    "model": {},
    "train": {"sem": {}, "mask": {}},
    "dataaug": {},
    "tpu": {},
}

# Options that stay at the root of the json even though they carry a section
# prefix (reference options/common_options.py:58).
GENERAL_OPTIONS = ("model_type",)


def flatten_json(src, out=None, prefix=""):
    """Nested dict -> flat dict with ``_``-joined keys."""
    if out is None:
        out = {}
    for k, v in src.items():
        if isinstance(v, dict):
            flatten_json(v, out, prefix + k + "_")
        else:
            out[prefix + k] = v
    return out


def split_key(key, template=None):
    """Flat flag name -> nested json path, e.g.
    ``data_online_creation_crop_delta_A`` -> ("data","online_creation","crop_delta_A")."""
    if template is None:
        template = SCHEMA_TEMPLATE
    if key in GENERAL_OPTIONS:
        return (key,)
    for prop, sub in template.items():
        if key.startswith(prop + "_"):
            return (prop,) + split_key(key[len(prop) + 1:], sub)
    return (key,)


def unflatten_json(flat):
    """Flat flag dict -> nested json tree following SCHEMA_TEMPLATE."""
    nested = {}
    for k, v in flat.items():
        path = split_key(k)
        parent = nested
        for cat in path[:-1]:
            parent = parent.setdefault(cat, {})
        parent[path[-1]] = v
    return nested


def str2bool(v):
    if isinstance(v, bool):
        return v
    s = str(v).lower()
    if s in ("yes", "true", "t", "y", "1"):
        return True
    if s in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected, got %r" % v)


def pairs_of_floats(arg):
    if isinstance(arg, (list, tuple)):
        return [float(x) for x in arg]
    return [float(x) for x in arg.split(",")] if arg else []


def pairs_of_ints(arg):
    if isinstance(arg, (list, tuple)):
        return [int(x) for x in arg]
    return [int(x) for x in arg.split(",")] if arg else []


_TYPE_MAP = {
    "int": int,
    "float": float,
    "str": str,
    "bool": str2bool,
    "str2bool": str2bool,
    "pairs_of_ints": pairs_of_ints,
    "pairs_of_floats": pairs_of_floats,
    None: str,
}

# TPU-native flags added by this framework (not in the reference).
TPU_FLAGS = {
    "tpu_mesh_data": {"type": "int", "default": -1,
                      "help": "data-parallel mesh axis size (-1 = all devices)"},
    "tpu_mesh_fsdp": {"type": "int", "default": 1,
                      "help": "fsdp (param-sharding) mesh axis size"},
    "tpu_mesh_tensor": {"type": "int", "default": 1,
                        "help": "tensor-parallel mesh axis size"},
    "tpu_mesh_seq": {"type": "int", "default": 1,
                     "help": "sequence-parallel mesh axis: shards the video "
                             "FRAME dimension of (B,F,H,W,C) clips"},
    "tpu_bf16": {"type": "bool", "default": True,
                 "help": "run forward/backward in bfloat16 with fp32 master params"},
    "tpu_remat": {"type": "bool", "default": False,
                  "help": "rematerialize (jax.checkpoint) generator blocks"},
    "tpu_remat_policy": {"type": "str", "default": "conv",
                         "choices": ["conv", "full"],
                         "help": "remat residuals: 'conv' saves MXU outputs "
                                 "and recomputes elementwise chains (HBM "
                                 "bandwidth lever); 'full' saves nothing "
                                 "(max memory headroom)"},
    "tpu_optim_moment_dtype": {
        "type": "str", "default": "float32",
        "choices": ["float32", "bfloat16"],
        "help": "storage dtype of the adam/adamw/radam/lion first moment "
                "(bfloat16 halves its HBM traffic; the second moment always "
                "stays fp32 — (1-b2)*g^2 increments vanish below bf16 ulp; "
                "madgrad/muon ignore this)"},
    "tpu_donate": {"type": "bool", "default": True,
                   "help": "donate train-state buffers to the jitted step"},
    "tpu_prefetch": {"type": "int", "default": 2,
                     "help": "device prefetch depth of the input pipeline"},
    "tpu_profile_dir": {"type": "str", "default": "",
                        "help": "write jax.profiler traces here (empty = off)"},
    "tpu_cache_dir": {"type": "str", "default": "",
                      "help": "persistent XLA compilation cache directory"},
    "tpu_dist_coordinator": {
        "type": "str", "default": "",
        "help": "multi-host: coordinator address host:port for "
                "jax.distributed.initialize (reference equivalent: "
                "MASTER_ADDR + --ddp_port, train.py:38-48); empty = "
                "single-host. Env fallback JOLIGEN_DIST_COORDINATOR; "
                "JOLIGEN_DIST_AUTO=1 uses pod auto-detection instead"},
    "tpu_dist_num_processes": {
        "type": "int", "default": 0,
        "help": "multi-host: total process (host) count "
                "(env JOLIGEN_DIST_NUM_PROCESSES)"},
    "tpu_dist_process_id": {
        "type": "int", "default": -1,
        "help": "multi-host: this process's id in [0, num_processes) "
                "(env JOLIGEN_DIST_PROCESS_ID)"},
}

# Flags the reference reads via getattr() without registering (internal
# overrides of the JiT variant table, reference diffusion_networks.py:258-330).
EXTRA_FLAGS = {
    "G_vit_depth": {"type": "int", "default": None,
                    "help": "override JiT variant depth"},
    "G_vit_hidden_size": {"type": "int", "default": None,
                          "help": "override JiT variant hidden size"},
    "G_vit_num_heads": {"type": "int", "default": None,
                        "help": "override JiT variant head count"},
    "G_vit_patch_size": {"type": "int", "default": None,
                         "help": "override JiT variant patch size"},
    "G_vit_bottleneck_dim": {"type": "int", "default": None,
                             "help": "override JiT bottleneck dim"},
    "G_vit_in_context_len": {"type": "int", "default": None,
                             "help": "override JiT in-context class-token "
                                     "count (reference default 32)"},
    "G_vit_in_context_start": {"type": "int", "default": None,
                               "help": "override the block index where JiT "
                                       "inserts register/in-context tokens "
                                       "(reference variant table: B=4, "
                                       "L=8, H=10)"},
    "G_vit_disable_bottleneck": {"type": "bool", "default": False,
                                 "help": "patch-embed straight to hidden "
                                         "size (bottleneck_dim = "
                                         "hidden_size)"},
    "f_s_vgg_pad": {
        "type": "str", "default": "same", "choices": ["same", "fcn"],
        "help": "VGG16-FCN8s padding scheme: 'same' (TPU-native — no "
                "99px outer pad, 3.15x fewer trunk pixels at 256px, same "
                "param tree) or 'fcn' (reference-exact Caffe-era "
                "construction for bit-parity with ported checkpoints)"},
    "G_unet_mha_attn_norm": {
        "type": "str", "default": "group", "choices": ["group", "instance"],
        "help": "unet_mha attention pre-norm: 'group' (this framework) or "
                "'instance' (reference-exact InstanceNorm1d; set by "
                "tools/convert_reference_checkpoint.py)"},
    "G_unet_vid_cross_attention_dim": {
        "type": "int", "default": 768,
        "help": "unet_vid motion-transformer inner attention dim (appears "
                "in the reference example_ddpm_vid_mario_ft configs; the "
                "reference hardcodes 768 in unet_generator_attn_vid.py:380 "
                "with no option flag — registered here so the configs "
                "round-trip)"},
    "G_resnet_up_mode": {
        "type": "str", "default": "resize",
        "choices": ["resize", "convtranspose"],
        "help": "resnet G decoder upsampling: 'resize' (TPU-native "
                "broadcast upsample + conv, checkerboard-free) or "
                "'convtranspose' (reference-exact ConvTranspose2d taps so "
                "converted reference GAN checkpoints reproduce reference "
                "outputs; set by tools/convert_reference_checkpoint.py)"},
    "alg_mat_first_stage_dim": {
        "type": "int", "default": 180,
        "help": "MAT first-stage token width (reference FirstStage "
                "dim=180, mat.py:966; must be divisible by 6 heads)"},
    "G_prompt": {
        "type": "str", "default": "",
        "help": "text prompt for the img2img_turbo generator (appears in "
                "the reference example_cut_turbo config but is undefined "
                "even in the reference's own option parser; registered "
                "here so the config round-trips — img2img_turbo itself is "
                "out of scope: disabled upstream, needs SD weights)"},
}


class Opt(SimpleNamespace):
    """Flat option namespace (attribute access by flat flag name)."""

    def get(self, key, default=None):
        return getattr(self, key, default)


def _load_registry(include_inference=False):
    with open(os.path.join(_HERE, "reference_schema.json")) as f:
        full = json.load(f)
    reg = {}
    for name, spec in full.items():
        scopes = spec.get("scopes", [])
        is_inference_only = scopes and all(
            s.startswith("options:inference_") for s in scopes
        )
        if is_inference_only != include_inference:
            continue
        reg[name] = spec
    if not include_inference:
        # framework extension: colorization layout is kept even though the
        # reference dropped it from the mode choices (its dataset class
        # still exists upstream, data/colorization_dataset.py)
        dm = reg.get("data_dataset_mode")
        if dm and dm.get("choices") and "colorization" not in dm["choices"]:
            dm["choices"] = list(dm["choices"]) + ["colorization"]
        # the reference ships segmentation/test model classes without listing
        # them as CLI choices (models/segmentation_model.py, test_model.py);
        # expose them properly here
        mt = reg.get("model_type")
        if mt and mt.get("choices"):
            for extra_model in ("segmentation", "test"):
                if extra_model not in mt["choices"]:
                    mt["choices"] = list(mt["choices"]) + [extra_model]
        for extra in (TPU_FLAGS, EXTRA_FLAGS):
            for k, v in extra.items():
                spec = dict(v)
                spec["name"] = k
                spec["scopes"] = ["tpu"]
                reg[k] = spec
    return reg


class OptionRegistry:
    """Parses options from CLI argv or nested JSON into a flat Opt namespace."""

    is_train = True
    include_inference = False

    def __init__(self):
        self.registry = _load_registry(include_inference=self.include_inference)

    # ---------------- JSON path ----------------
    def parse_json(self, json_args, save_config=False, verbose=True):
        flat = flatten_json(json_args)
        opt = self.defaults()
        unknown = []
        for name, val in flat.items():
            if name not in self.registry:
                unknown.append(name)
                continue
            setattr(opt, name, self._coerce(name, val))
        if unknown and verbose:
            print(
                "%d unknown keys in json config (ignored): %s"
                % (len(unknown), ",".join(sorted(unknown))),
                file=sys.stderr,
            )
        return self.after_parse(opt)

    # ---------------- CLI path ----------------
    def build_parser(self):
        parser = argparse.ArgumentParser(
            description="joliGEN-TPU", formatter_class=argparse.ArgumentDefaultsHelpFormatter
        )
        parser.add_argument("--config_json", type=str, default="",
                            help="path of a nested json config; CLI flags override it")
        for name, spec in sorted(self.registry.items(), key=lambda kv: kv[1].get("order", 0)):
            ty = _TYPE_MAP.get(spec.get("type"), str)
            kwargs = {"type": ty, "default": spec.get("default"),
                      "help": spec.get("help", "")}
            if spec.get("nargs") is not None:
                kwargs["nargs"] = spec["nargs"]
            if spec.get("choices"):
                kwargs["choices"] = spec["choices"]
            if ty is str2bool:
                kwargs["nargs"] = "?"
                kwargs["const"] = True
            parser.add_argument("--" + name, **kwargs)
        return parser

    def parse_cli(self, argv=None):
        parser = self.build_parser()
        ns, unknown = parser.parse_known_args(argv)
        if unknown:
            print("unknown CLI flags (ignored): %s" % " ".join(unknown), file=sys.stderr)
        json_base = {}
        if ns.config_json:
            with open(ns.config_json) as f:
                json_base = json.load(f)
        opt = self.parse_json(json_base) if json_base else self.after_parse(self.defaults())
        # CLI overrides: only flags explicitly present on the command line
        given = self._explicit_flags(argv if argv is not None else sys.argv[1:])
        for name in given:
            if hasattr(ns, name):
                setattr(opt, name, getattr(ns, name))
        return self.after_parse(opt)

    @staticmethod
    def _explicit_flags(argv):
        out = set()
        for tok in argv:
            if tok.startswith("--"):
                out.add(tok[2:].split("=")[0])
        return out

    # ---------------- core ----------------
    def defaults(self):
        opt = Opt()
        for name, spec in self.registry.items():
            setattr(opt, name, copy.deepcopy(spec.get("default")))
        return opt

    def _coerce(self, name, val):
        spec = self.registry[name]
        ty = spec.get("type")
        if val is None:
            return None
        if ty == "float" and isinstance(val, int):
            return float(val)
        if ty in ("bool", "str2bool") and not isinstance(val, bool):
            return str2bool(val)
        if ty in ("pairs_of_ints", "pairs_of_floats") and isinstance(val, str):
            return _TYPE_MAP[ty](val)
        return val

    def to_json(self, opt, ignore_default=False):
        flat = {}
        for name, spec in self.registry.items():
            if not hasattr(opt, name):
                continue
            v = getattr(opt, name)
            if ignore_default and v == spec.get("default"):
                continue
            flat[name] = v
        return unflatten_json(flat)

    def get_schema(self):
        """JSON-schema-ish dict of all options (for the REST server / docs)."""
        props = {}
        for name, spec in self.registry.items():
            path = split_key(name)
            node = props
            for cat in path[:-1]:
                node = node.setdefault(cat, {"type": "object", "properties": {}})["properties"]
            entry = {"default": spec.get("default")}
            if spec.get("choices"):
                entry["enum"] = spec["choices"]
            if spec.get("help"):
                entry["description"] = spec["help"]
            tymap = {"int": "integer", "float": "number", "str": "string",
                     "bool": "boolean", "str2bool": "boolean"}
            if spec.get("type") in tymap:
                entry["type"] = tymap[spec["type"]]
            node[path[-1]] = entry
        return {"title": type(self).__name__, "type": "object", "properties": props}

    def after_parse(self, opt):
        opt.isTrain = self.is_train
        if getattr(opt, "suffix", "") and not getattr(
                opt, "_suffix_applied", False):
            # idempotent: parse_cli finalizes an opt that parse_json may
            # already have finalized — without the guard the suffix would
            # append twice and checkpoints land in the wrong directory
            opt.name = opt.name + opt.suffix
            opt._suffix_applied = True
        # interpret gpu_ids as a device-count hint; JAX owns device placement
        gpu_ids = getattr(opt, "gpu_ids", "0") or "0"
        if isinstance(gpu_ids, str):
            ids = [int(x) for x in gpu_ids.split(",") if x.strip() != ""]
        else:
            ids = list(gpu_ids)
        opt.gpu_ids = [i for i in ids if i >= 0]
        opt.use_cuda = len(opt.gpu_ids) > 0  # compat naming; means "use accelerator"
        if not hasattr(opt, "jg_dir"):
            opt.jg_dir = os.path.dirname(os.path.dirname(_HERE))
        return opt

    # ---------------- topic help (reference options/helpers.py:61-121,
    # base_options.py:445-488) ----------------
    def get_topics(self):
        """Help topics incl. nested alg subsections (e.g. ``alg_palette``)."""
        tops = set()
        for n in self.registry:
            path = split_key(n)
            if len(path) > 1:
                tops.add(path[0])
            if len(path) > 2:
                tops.add("_".join(path[:2]))
        return sorted(tops)

    def topic_flags(self, topic):
        """Flags whose flat name lives under ``topic`` ('alg_palette' matches
        the nested alg/palette section; reference topic help)."""
        out = []
        for n in self.registry:
            path = split_key(n)
            joined = ["_".join(path[:k]) for k in range(1, len(path))]
            if topic in joined:
                out.append(n)
        return sorted(out)

    def print_topic_help(self, topic=None, file=None):
        file = file or sys.stdout
        if topic is None or topic == "":
            print("help topics (use --help <topic>):", file=file)
            for t in self.get_topics():
                print(f"  {t}", file=file)
            return
        flags = self.topic_flags(topic)
        if not flags:
            print(f"unknown topic '{topic}'; topics: "
                  f"{', '.join(self.get_topics())}", file=file)
            return
        print(f"options in topic '{topic}':", file=file)
        for n in flags:
            spec = self.registry[n]
            extra = f" (default: {spec.get('default')})"
            if spec.get("choices"):
                extra += f" choices: {spec['choices']}"
            print(f"  --{n}: {spec.get('help', '')}{extra}", file=file)

    def save_config(self, opt, expr_dir):
        os.makedirs(expr_dir, exist_ok=True)
        with open(os.path.join(expr_dir, "train_config.json"), "w") as f:
            json.dump(self.to_json(opt), f, indent=4, default=str)
        with open(os.path.join(expr_dir, "command_line.txt"), "w") as f:
            f.write(" ".join(sys.argv) + "\n")


class TrainOptions(OptionRegistry):
    is_train = True


class InferenceOptions(OptionRegistry):
    """Options for the standalone inference scripts (reference
    options/inference_diffusion_options.py / inference_gan_options.py)."""

    is_train = False
    include_inference = True
