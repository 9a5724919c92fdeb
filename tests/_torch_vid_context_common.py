"""Helpers of the b2b context tests (``tests/test_torch_vit_vid_context.py``,
``_b2b_context.py``): the JAX ``JiTViD`` with its object references
working, and seeded small configs.

The JAX package's ``JiTViD`` cannot run with object references: its
nested ``_build_prefix`` assigns ``object_ref`` (the zero stand-in when
none is given), which makes the name local to that function, so the read
before it raises ``UnboundLocalError`` whether references are given or not
(``joligen_tpu/models/modules/vit_vid.py:285,316-317``). ``fixed_vit_vid``
loads a copy of that module with one line added, ``nonlocal object_ref``,
and nothing else changed; the package itself stays as it is. Every other
branch of the copy is the package's code, so it holds the port to the
JAX design."""

import inspect
import sys
import types

BROKEN = ("        def _build_prefix():\n"
          "            n_prefix, prefix = 0, []\n")
FIXED = ("        def _build_prefix():\n"
         "            nonlocal object_ref\n"
         "            n_prefix, prefix = 0, []\n")
_CACHE = {}


def fixed_vit_vid():
    """The JAX ``vit_vid`` module with ``_build_prefix`` reading the
    caller's ``object_ref`` (see the module doc), loaded once."""
    if "mod" not in _CACHE:
        from joligen_tpu.models.modules import vit_vid
        src = inspect.getsource(vit_vid)
        assert src.count(BROKEN) == 1
        name = vit_vid.__name__ + "_object_refs"
        mod = types.ModuleType(name)
        mod.__package__ = vit_vid.__package__
        mod.__file__ = vit_vid.__file__
        sys.modules[name] = mod
        exec(compile(src.replace(BROKEN, FIXED), vit_vid.__file__, "exec"),
             mod.__dict__)
        _CACHE["mod"] = mod
    return _CACHE["mod"]
