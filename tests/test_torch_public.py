"""The port's public surface: every name that an `__init__.py` of the JAX
package re-exports or defines resolves in the port's counterpart package,
and is the same object as the port module's attribute it stands for. The
names are read from the JAX sources with `ast`, so a name JAX adds later
shows here. `import vehicle_counting_tpu_torch` stays cheap."""

import ast
import glob
import importlib
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "vehicle_counting_tpu", "vehicle_counting_tpu_torch"

# Left out on purpose: XLA's compilation cache is `_build.py`'s kernel
# cache in the port; JAX's sharding names belong to jax.
EXCLUDED = {
    "pipeline": {"enable_compilation_cache", "NamedSharding", "P"},
}
# the TPU kernels' package: its kernels are csrc/ (not carried over, on purpose)
NO_COUNTERPART = {"ops/pallas"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six test workers at once, and
    more threads per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_inits():
    files = glob.glob(os.path.join(REPO, JAX_PKG, "**", "__init__.py"), recursive=True)
    rels = sorted(os.path.relpath(os.path.dirname(f), os.path.join(REPO, JAX_PKG)) for f in files)
    return [r for r in rels if r not in NO_COUNTERPART]


def _public_names(sub):
    """{name: the JAX module it is imported from, or None} for one JAX
    `__init__.py`: `from vehicle_counting_tpu... import` names, `__all__`,
    public top-level defs and classes, and the names its `__getattr__`
    answers lazily (`name == "..."`)."""
    path = os.path.join(REPO, JAX_PKG, *([] if sub == "." else [sub]), "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 0 and (node.module or "").split(".")[0] == JAX_PKG:
            names.update({a.asname or a.name: node.module for a in node.names})
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.setdefault(node.name, None)
        elif isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            names.update({n: names.get(n) for n in ast.literal_eval(node.value)})
        if isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            for cmp in ast.walk(node):
                if isinstance(cmp, ast.Compare) and isinstance(cmp.comparators[0], ast.Constant):
                    lazy = cmp.comparators[0].value
                    for imp in ast.walk(node):
                        if isinstance(imp, ast.ImportFrom) and lazy in {a.name for a in imp.names}:
                            names[lazy] = imp.module
    return {n: m for n, m in names.items() if n not in EXCLUDED.get(sub, ())}


def test_the_jax_inits_are_read():
    """The ast reader finds every JAX `__init__.py` and the names each one exports."""
    assert {".", "ops", "models", "tracking", "utils", "counting", "configs", "data", "parallel",
            "serving", "pipeline"} <= set(_jax_inits())
    assert _public_names(".") == {"__version__": "vehicle_counting_tpu.version",
                                  "Config": "vehicle_counting_tpu.configs",
                                  "config_from_dict": "vehicle_counting_tpu.configs",
                                  "CountingPipeline": "vehicle_counting_tpu.pipeline"}
    assert len(_public_names("ops")) == 18 and len(_public_names("models")) == 9
    assert len(_public_names("tracking")) == 9 and len(_public_names("utils")) == 8


@pytest.mark.parametrize("sub", _jax_inits())
def test_public_names_resolve_in_the_port(sub):
    port = importlib.import_module(PORT_PKG if sub == "." else f"{PORT_PKG}.{sub.replace(os.sep, '.')}")
    names = _public_names(sub)
    assert names or sub == "tools"
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"{port.__name__} lacks {missing}"
    for name, jax_module in names.items():
        if jax_module is None:
            continue
        # the port module the name stands for, loaded first: a submodule of
        # the same name (ops.letterbox) must not take the name's place
        home = importlib.import_module(PORT_PKG + jax_module[len(JAX_PKG):])
        assert getattr(port, name) is getattr(home, name), f"{port.__name__}.{name}"
        assert getattr(importlib.import_module(port.__name__), name) is getattr(home, name)


@pytest.mark.parametrize("sub", [".", "ops", "models", "tracking", "utils"])
def test_all_lists_every_public_name(sub):
    port = importlib.import_module(PORT_PKG if sub == "." else f"{PORT_PKG}.{sub}")
    want = set(_public_names(sub)) - ({"CountingPipeline"} if sub == "." else set())
    assert want <= set(port.__all__)
    assert all(hasattr(port, n) for n in port.__all__)


def test_unknown_name_raises_attribute_error():
    import vehicle_counting_tpu_torch.ops as ops

    with pytest.raises(AttributeError, match="no attribute 'nothing_here'"):
        ops.nothing_here  # noqa: B018
    assert not hasattr(importlib.import_module(PORT_PKG), "nothing_here")


def test_import_is_cheap():
    """`import vehicle_counting_tpu_torch` (and its lazy subpackages) reads
    neither cv2 nor the pipeline, nor any op module."""
    code = (
        "import sys\n"
        "import vehicle_counting_tpu_torch, vehicle_counting_tpu_torch.ops, vehicle_counting_tpu_torch.tracking\n"
        "import vehicle_counting_tpu_torch.models, vehicle_counting_tpu_torch.utils\n"
        "from vehicle_counting_tpu_torch import Config, config_from_dict\n"
        "bad = [m for m in sys.modules if m == 'cv2' or m.startswith(('vehicle_counting_tpu_torch.pipeline',\n"
        "       'vehicle_counting_tpu_torch.ops.', 'vehicle_counting_tpu_torch.tracking.',\n"
        "       'vehicle_counting_tpu_torch.models.'))]\n"
        "assert not bad, bad\n"
        "from vehicle_counting_tpu_torch import CountingPipeline\n"
        "assert 'vehicle_counting_tpu_torch.pipeline' in sys.modules\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# call parity: a call written for a JAX function is a call of the port's
# ---------------------------------------------------------------------------
#
# Every public top-level function of a JAX module whose port counterpart
# (the same path under the port's package) defines the same name, which
# takes in every function a JAX `__init__.py` exports: its parameters'
# names, kinds (positional or keyword-only) and defaults, read from both
# sources with `ast`, must match. Defaults compare as literals (str, int,
# float, bool, None, tuples) or, where they are expressions, as source
# text. Three departures are what PyTorch's idiom needs, and no others
# pass unlisted:
#
# 1. A JAX PRNG key is a `torch.Generator` in the port, named `gen`; where
#    the port's generator may be None (no random draw), a JAX call, which
#    always passes its key, still works. {function: (JAX name, port name)}
KEY_TO_GENERATOR = {
    "models/layers.py::init_conv": ("key", "gen"),
    "models/yolo.py::init_yolov5": ("key", "gen"),
    "models/reid.py::init_reid": ("key", "gen"),
    "train/augment.py::random_flip": ("key", "gen"),
    "train/augment.py::random_rotate": ("key", "gen"),
    "train/augment.py::augment_batch": ("key", "gen"),
    "train/reid_train.py::create_train_state": ("key", "gen"),
    "train/reid_train.py::train_step": ("step_key", "gen"),
}
# 2. A trailing keyword the port adds after all of JAX's parameters, with a
#    default, naming where the work runs: a torch device (JAX places arrays
#    by its default device or a sharding) or a mesh (JAX's is implicit in
#    its shardings).
TRAILING_PLACEMENT = {"device", "device_type", "mesh"}
# 3. A dtype default: `jnp.<name>` in JAX is `torch.<name>` in the port
#    (checked by `_default`).
#
# Every other departure is listed here, by the parameters it concerns, with
# the reason the port keeps it. A JAX call of each still works unless its
# reason says otherwise.
OTHER_DEPARTURES = {
    # K1's wrapper takes the planar [B, 3, H, W] frames its kernel reads (as
    # JAX's kernel entry `ops/pallas/crops.py::gather_crops_batch_pallas`
    # does), and only the ReID crop size; JAX's XLA gather of the same name
    # takes interleaved frames and any size. A JAX call with interleaved
    # frames does NOT work: use `gather_crops` per frame, or
    # `tracking/deepsort.py::embed_detections_batch`, which take both.
    "ops/crops.py::gather_crops_batch": {"frames", "frames_planar", "out_size", "dtype"},
    # the inference embed takes the convolutions' compute dtype (None: f32,
    # JAX's jitted `reid_embed` computes in f32 always)
    "models/reid.py::reid_embed": {"dtype"},
    # a tracker state for `num_classes` classes, or one class's without the
    # class axis (None: JAX's call)
    "tracking/tracker.py::init_state": {"num_classes"},
    # the upload's CUDA-event timing, for `bench`'s GB/s (None: JAX's call)
    "utils/transfer.py::parallel_device_put": {"timing"},
    # the port writes its traces under the working directory, not /tmp
    "utils/profiling.py::trace": {"log_dir"},
    # the CLIs take their arguments, so tests run them in-process (None:
    # sys.argv, JAX's call)
    "tools/convert_weights.py::main": {"argv"},
    "train/reid_cli.py::main": {"argv"},
}


def _default(node):
    if node is None:
        return "<required>"
    try:
        return repr(ast.literal_eval(node))
    except ValueError:
        text = ast.unparse(node)
        for lib in ("jnp.", "torch."):  # 3. dtypes
            if text.startswith(lib) and text[len(lib):].isidentifier():
                return "dtype:" + text[len(lib):]
        return text


def _params(fn):
    """[(name, kind, default)] of a FunctionDef, in order."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + a.defaults
    out = [(p.arg, "positional", _default(d)) for p, d in zip(pos, defaults)]
    if a.vararg:
        out.append(("*" + a.vararg.arg, "var", ""))
    out += [(p.arg, "keyword", _default(d)) for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    if a.kwarg:
        out.append(("**" + a.kwarg.arg, "var", ""))
    return out


def _defs(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")}


def _shared_modules():
    """Relative paths of the JAX modules whose port counterpart exists."""
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, JAX_PKG, "**", "*.py"), recursive=True)):
        rel = os.path.relpath(path, os.path.join(REPO, JAX_PKG))
        if os.path.exists(os.path.join(REPO, PORT_PKG, rel)) and _defs(path):
            out.append(rel.replace(os.sep, "/"))
    return out


def _departures(rel):
    """{function: the parameter names where the port's signature departs
    from JAX's past the three idiom rules} for one module, over every
    function both define."""
    jax_defs = _defs(os.path.join(REPO, JAX_PKG, rel))
    port_defs = _defs(os.path.join(REPO, PORT_PKG, rel))
    out = {}
    for name in sorted(set(jax_defs) & set(port_defs)):
        key = f"{rel}::{name}"
        want, have = _params(jax_defs[name]), _params(port_defs[name])
        if key in KEY_TO_GENERATOR:
            jax_name, port_name = KEY_TO_GENERATOR[key]
            want = [(port_name, k, d) if n == jax_name else (n, k, d) for n, k, d in want]
            have = [(n, k, want[i][2] if n == port_name and d == "None" and i < len(want) else d)
                    for i, (n, k, d) in enumerate(have)]
        if have[:len(want)] == want:  # 2. trailing placement keywords
            have = want + [p for p in have[len(want):] if p[0] not in TRAILING_PLACEMENT or p[2] == "<required>"]
        differ = {n for n, *_ in set(want) ^ set(have)}
        if differ:
            out[key] = differ
    return out


def test_the_signature_reader_sees_a_changed_default():
    """The guard's reader on two small sources: a default put back to
    another literal is a departure, a jnp/torch dtype and a trailing device
    are not."""
    jax_fn = ast.parse("def f(x, *, fmt='raw_rgb', dtype=jnp.bfloat16, max_det=300): pass").body[0]
    for port_src, differ in (("def f(x, *, fmt='raw_rgb', dtype=torch.bfloat16, max_det=300, device=None): pass", set()),
                             ("def f(x, *, fmt='letterboxed_yuv420', dtype=torch.bfloat16, max_det=300): pass", {"fmt"}),
                             ("def f(x, fmt='raw_rgb', *, dtype=torch.bfloat16, max_det=300): pass", {"fmt"}),
                             ("def f(x, *, dtype=torch.bfloat16, max_det=300): pass", {"fmt"})):
        want, have = _params(jax_fn), _params(ast.parse(port_src).body[0])
        if have[:len(want)] == want:
            have = want + [p for p in have[len(want):] if p[0] not in TRAILING_PLACEMENT]
        assert {n for n, *_ in set(want) ^ set(have)} == differ, port_src


@pytest.mark.parametrize("rel", _shared_modules())
def test_jax_calls_are_port_calls(rel):
    """Every function both packages define in this module takes JAX's call:
    the same parameter names, kinds and defaults, past the three idiom
    rules and the listed departures (whose parameters must be the ones that
    still depart, so the list stays exact)."""
    got = _departures(rel)
    listed = {k: v for k, v in OTHER_DEPARTURES.items() if k.startswith(rel + "::")}
    assert got == listed


def test_the_guard_covers_the_exported_functions():
    """Every function a JAX `__init__.py` exports from a module the port
    also has is among those the guard compares, and so are the step
    functions no `__init__` exports."""
    covered = {f"{rel}::{name}" for rel in _shared_modules()
               for name in set(_defs(os.path.join(REPO, JAX_PKG, rel))) & set(_defs(os.path.join(REPO, PORT_PKG, rel)))}
    exported = set()
    for sub in _jax_inits():
        for name, module in _public_names(sub).items():
            if module is None:
                continue
            rel = module[len(JAX_PKG) + 1:].replace(".", "/") + ".py"
            path = os.path.join(REPO, JAX_PKG, rel)
            if os.path.exists(path) and name in _defs(path) and name in _defs(os.path.join(REPO, PORT_PKG, rel)):
                exported.add(f"{rel}::{name}")
    assert len(exported) > 40 and exported <= covered
    assert {"pipeline/step.py::pipeline_batch_step", "pipeline/step.py::detect_embed_core",
            "pipeline/step.py::detect_only_step", "tracking/assignment.py::matching_cost_matrix",
            "models/reid.py::reid_forward", "parallel/cameras.py::make_multicam_step"} <= covered
