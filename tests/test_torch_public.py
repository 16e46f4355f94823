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


def _differ(key, jax_fn, port_fn):
    """The parameter names where the port function's signature departs
    from the JAX function's past the three idiom rules."""
    want, have = _params(jax_fn), _params(port_fn)
    if key in KEY_TO_GENERATOR:
        jax_name, port_name = KEY_TO_GENERATOR[key]
        want = [(port_name, k, d) if n == jax_name else (n, k, d) for n, k, d in want]
        have = [(n, k, want[i][2] if n == port_name and d == "None" and i < len(want) else d)
                for i, (n, k, d) in enumerate(have)]
    if have[:len(want)] == want:  # 2. trailing placement keywords
        have = want + [p for p in have[len(want):] if p[0] not in TRAILING_PLACEMENT or p[2] == "<required>"]
    return {n for n, *_ in set(want) ^ set(have)}


def _departures(rel):
    """{function: the parameter names where the port's signature departs
    from JAX's past the three idiom rules} for one module, over every
    function both define."""
    jax_defs = _defs(os.path.join(REPO, JAX_PKG, rel))
    port_defs = _defs(os.path.join(REPO, PORT_PKG, rel))
    out = {}
    for name in sorted(set(jax_defs) & set(port_defs)):
        key = f"{rel}::{name}"
        differ = _differ(key, jax_defs[name], port_defs[name])
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
        assert _differ("m.py::f", jax_fn, ast.parse(port_src).body[0]) == differ, port_src


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


# ---------------------------------------------------------------------------
# what JAX's code sets, reads or types works on the port: names, fields,
# environment switches and CLI flags
# ---------------------------------------------------------------------------
#
# Each check reads both packages with `ast` and has an exact list of what
# the port leaves out on purpose, each entry with its reason: an entry that
# no longer departs fails the check as a new departure does.

# JAX modules with no counterpart at their own path in the port
MODULES_NOT_CARRIED = {
    # the Pallas kernels: their Hopper counterparts are csrc/*.cu behind ops/*.py
    "ops/pallas/",
    # reads XLA's xplane protobuf; the port's traces are torch.profiler's
    # Chrome traces, read by tools/profile_summary.py (its flags: FLAG_PAIRS)
    "tools/xprof_summary.py",
}
# (a) public top-level names of a shared JAX module the port's counterpart
# does not define
NAMES_NOT_CARRIED = {
    # the TPU detect tail's candidate-row layout (env VCT_TAIL_ROWS); the
    # port's tail has one layout
    "models/detector.py::TAIL_ROWS_MODE",
    # lax.top_k's result in two phases, a TPU workaround; the port's top-k
    # is one stable sort (ops/nms.py::stable_topk)
    "models/detector.py::exact_topk",
    # XLA's `dimension_numbers` argument: no torch call takes one (the
    # port's conv2d takes NHWC activations and OIHW weights)
    "models/layers.py::DN",
    # XLA's compilation cache; the port's counterpart is _build.py's kernel cache
    "pipeline/__init__.py::enable_compilation_cache",
    # forces the Pallas crop gather; the port routes K1 by the tensor's device
    "tracking/deepsort.py::FORCE_PALLAS_CROPS",
    # picks one of two Pallas grids; the port has one CUDA kernel for every
    # class (K2), whose one-class entry is K3
    "tracking/tracker.py::CASCADE_CLASS_PARALLEL",
}
# (c) environment variables the JAX package reads (outside ops/pallas/,
# whose variables tune the Pallas kernels) and the port does not
ENV_NOT_CARRIED = {
    # the TPU's planar u8 pixel layout into the crop kernel; the port's
    # path is planar always
    "VCT_PLANAR_PIXELS",
    # lax.scan's unroll of the tracker's frame scan; the port's frame scan
    # is a CUDA graph replayed per frame
    "VCT_SCAN_UNROLL",
    # TAIL_ROWS_MODE's variable (above)
    "VCT_TAIL_ROWS",
}
# (d) the JAX package's CLIs (and the repo's root scripts) against the
# port's: {JAX file: port file}, paths from the repo root
FLAG_PAIRS = {
    f"{JAX_PKG}/evaluation.py": f"{PORT_PKG}/evaluation.py",
    f"{JAX_PKG}/train/reid_cli.py": f"{PORT_PKG}/train/reid_cli.py",
    f"{JAX_PKG}/serving/cli.py": f"{PORT_PKG}/serving/cli.py",
    **{f"{JAX_PKG}/tools/{os.path.basename(p)}": f"{PORT_PKG}/tools/{os.path.basename(p)}"
       for p in sorted(glob.glob(os.path.join(REPO, JAX_PKG, "tools", "*.py")))
       if os.path.basename(p) not in ("__init__.py", "xprof_summary.py")},
    f"{JAX_PKG}/tools/xprof_summary.py": f"{PORT_PKG}/tools/profile_summary.py",
    **{rel: f"{PORT_PKG}/{rel}" for rel in ("run.py", "bench.py", "stage_bench.py", "benchmarks/soak.py",
                                            "benchmarks/micro/noop_launch.py")},
}
FLAG_KEYS = ("default", "type", "action", "nargs", "choices", "const", "required")
# {"JAX file::[subcommand ]flag": the keys whose value departs, with the reason}
FLAGS_DEPARTING = {
    # the port writes under the system's temporary directory, not /tmp
    "benchmarks/soak.py::--out": {"default"},
    # the port writes its traces under the working directory, not /tmp (as
    # utils/profiling.py::trace, OTHER_DEPARTURES)
    "run.py::--profile": {"const"},
}


def _module_names(src):
    """Public top-level names a module's source defines: functions,
    classes, and assignments to a plain name."""
    names = set()
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _read(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return f.read()


def _counterparts():
    """Relative paths of every JAX module whose port counterpart exists."""
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, JAX_PKG, "**", "*.py"), recursive=True)):
        rel = os.path.relpath(path, os.path.join(REPO, JAX_PKG)).replace(os.sep, "/")
        if os.path.exists(os.path.join(REPO, PORT_PKG, rel)):
            out.append(rel)
    return out


def _port_module(rel):
    name = f"{PORT_PKG}.{rel[:-len('.py')].replace('/', '.')}"
    return importlib.import_module(name[:-len(".__init__")] if name.endswith(".__init__") else name)


def test_every_jax_module_has_a_counterpart():
    shared = set(_counterparts())
    rels = {os.path.relpath(p, os.path.join(REPO, JAX_PKG)).replace(os.sep, "/")
            for p in glob.glob(os.path.join(REPO, JAX_PKG, "**", "*.py"), recursive=True)}
    unlisted = {r for r in rels - shared if not any(r.startswith(m) for m in MODULES_NOT_CARRIED)}
    assert not unlisted
    assert all(any(r.startswith(m) for r in rels - shared) for m in MODULES_NOT_CARRIED)


def test_the_name_reader_sees_a_dropped_name():
    jax_src = "X = 1\nY: int = 2\n_private = 3\ndef f(): pass\nclass C: pass\nimport os\n"
    assert _module_names(jax_src) == {"X", "Y", "f", "C"}
    assert _module_names(jax_src) - _module_names("Y = 2\ndef f(): pass\nclass C: pass\n") == {"X"}


@pytest.mark.parametrize("rel", _counterparts())
def test_jax_names_resolve_in_the_port(rel):
    """(a) Every public top-level name of the JAX module resolves on the
    port's counterpart, past NAMES_NOT_CARRIED (whose entries for this
    module must be the names that are still missing)."""
    port = _port_module(rel)
    missing = {f"{rel}::{n}" for n in _module_names(_read(JAX_PKG, rel)) if not hasattr(port, n)}
    assert missing == {k for k in NAMES_NOT_CARRIED if k.startswith(rel + "::")}


def _classes(src):
    return {n.name: n for n in ast.parse(src).body if isinstance(n, ast.ClassDef)}


def _fields(cls):
    """[(name, default)] of a dataclass's or NamedTuple's annotated fields, in order."""
    return [(n.target.id, _default(n.value)) for n in cls.body
            if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)]


def _methods(cls):
    return {n.name: n for n in cls.body if isinstance(n, ast.FunctionDef)
            and (not n.name.startswith("_") or n.name in ("__init__", "__call__"))}


def _class_departures(rel, jax_src, port_src):
    """{"rel::Class": what departs} for every class both sources define:
    "fields" when the fields differ in name, order or default, else the
    public methods the port lacks or whose call departs (by _differ)."""
    jax_cls, port_cls = _classes(jax_src), _classes(port_src)
    out = {}
    for name in sorted(set(jax_cls) & set(port_cls)):
        key = f"{rel}::{name}"
        if _fields(jax_cls[name]) != _fields(port_cls[name]):
            out[key] = {"fields"}
            continue
        jm, pm = _methods(jax_cls[name]), _methods(port_cls[name])
        differ = {m for m in jm if m not in pm or _differ(f"{key}.{m}", jm[m], pm[m])}
        if differ:
            out[key] = differ
    return out


def test_the_field_reader_sees_a_moved_field():
    jax_src = ("@dataclass\nclass P:\n    a: int = 1\n    b: int = 2\n    dt: str = jnp.float32\n"
               "    def run(self, x, *, n=3): pass\n")
    same = jax_src.replace("jnp.", "torch.").replace("n=3)", "n=3, device=None)")
    assert _class_departures("m.py", jax_src, same) == {}
    moved = "@dataclass\nclass P:\n    b: int = 2\n    a: int = 1\n    dt: str = torch.float32\n"
    assert _class_departures("m.py", jax_src, moved) == {"m.py::P": {"fields"}}
    assert _class_departures("m.py", jax_src, same.replace("b: int = 2", "b: int = 3")) == {"m.py::P": {"fields"}}
    assert _class_departures("m.py", jax_src, same.replace("n=3", "n=4")) == {"m.py::P": {"run"}}
    assert _class_departures("m.py", jax_src, same.replace("def run", "def go")) == {"m.py::P": {"run"}}


@pytest.mark.parametrize("rel", [r for r in _counterparts() if set(_classes(_read(JAX_PKG, r)))
                                 & set(_classes(_read(PORT_PKG, r)))])
def test_jax_classes_are_port_classes(rel):
    """(b) Every class the JAX module and its counterpart both define has
    JAX's fields (name, order, default) and JAX's public methods, whose
    calls follow the idiom rules of `test_jax_calls_are_port_calls`."""
    assert _class_departures(rel, _read(JAX_PKG, rel), _read(PORT_PKG, rel)) == {}


def _env_reads(src):
    """Names of the environment variables a source reads: os.environ.get,
    os.getenv, os.environ[...] and `... in os.environ`."""
    out = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Call) and ast.unparse(node.func).endswith(("environ.get", "getenv")):
            key = node.args[0] if node.args else None
        elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
            key = node.slice if ast.unparse(node.value).endswith("environ") else None
        elif isinstance(node, ast.Compare) and isinstance(node.ops[0], ast.In):
            key = node.left if ast.unparse(node.comparators[0]).endswith("environ") else None
        else:
            continue
        if isinstance(key, ast.Constant) and isinstance(key.value, str):
            out.add(key.value)
    return out


def test_the_env_reader_sees_an_unread_variable():
    src = ("import os\nA = os.environ.get('A', '1')\nB = os.getenv('B')\nC = os.environ['C']\n"
           "D = 'D' in os.environ\nos.environ['E'] = '1'\n")
    assert _env_reads(src) == {"A", "B", "C", "D"}
    assert _env_reads(src) - _env_reads("import os\nB = os.getenv('B')\nC = os.environ['C']\nD = 'D' in os.environ\n") == {"A"}


def test_jax_env_switches_are_read_by_the_port():
    """(c) Every environment variable the JAX package (outside ops/pallas/)
    and the root scripts read is read by the port under the same name, past
    ENV_NOT_CARRIED (all of whose entries must still be unread)."""
    jax_files = [p for p in glob.glob(os.path.join(REPO, JAX_PKG, "**", "*.py"), recursive=True)
                 if not os.path.relpath(p, os.path.join(REPO, JAX_PKG)).startswith("ops" + os.sep + "pallas")]
    jax_files += [os.path.join(REPO, rel) for rel in FLAG_PAIRS if not rel.startswith(JAX_PKG)]
    jax_env = set().union(*(_env_reads(_read(p)) for p in jax_files))
    port_env = set().union(*(_env_reads(_read(p)) for p in glob.glob(os.path.join(REPO, PORT_PKG, "**", "*.py"),
                                                                      recursive=True)))
    assert {"FORCE_PALLAS_REID_BLOCK", "VCT_UPLOAD_STREAMS", "BENCH_BATCH"} <= jax_env
    assert jax_env - port_env == ENV_NOT_CARRIED


def _flags(src):
    """{(subcommand, option strings): [{key: value source}]} of every
    `add_argument` in a source, the subcommand read from `x =
    sub.add_parser("name")` ("" for the main parser)."""
    tree = ast.parse(src)
    sub = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and getattr(node.value.func, "attr", None) == "add_parser"):
            sub[ast.unparse(node.targets[0])] = node.value.args[0].value
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            key = (sub.get(ast.unparse(node.func.value), ""), tuple(a.value for a in node.args))
            out.setdefault(key, []).append({k.arg: _default(k.value) for k in node.keywords if k.arg in FLAG_KEYS})
    return out


def _flag_departures(jax_src, port_src):
    """{"[subcommand ]flag": the FLAG_KEYS whose value departs ("missing"
    when the port has no such flag)} for every flag of the JAX source."""
    jax_flags, port_flags = _flags(jax_src), _flags(port_src)
    out = {}
    for (cmd, opts), specs in jax_flags.items():
        key = f"{cmd} {opts[-1]}".lstrip()
        have = port_flags.get((cmd, opts))
        if have is None:
            out[key] = {"missing"}
        elif have != specs:
            out[key] = {k for a, b in zip(specs, have) for k in set(a) | set(b) if a.get(k) != b.get(k)} or {"count"}
    return out


def test_the_flag_reader_sees_a_changed_default():
    jax_src = ("ap.add_argument('--n', type=int, default=3)\nap.add_argument('-v', '--verbose', action='store_true')\n"
               "pe = sub.add_parser('export')\npe.add_argument('--out', required=True)\n")
    assert set(_flags(jax_src)) == {("", ("--n",)), ("", ("-v", "--verbose")), ("export", ("--out",))}
    port_src = jax_src + "ap.add_argument('--device', default='cuda')\n"
    assert _flag_departures(jax_src, port_src) == {}
    assert _flag_departures(jax_src, port_src.replace("default=3", "default=4")) == {"--n": {"default"}}
    assert _flag_departures(jax_src, port_src.replace("'-v', ", "")) == {"--verbose": {"missing"}}
    assert _flag_departures(jax_src, port_src.replace("pe = sub", "px = sub")) == {"export --out": {"missing"}}


@pytest.mark.parametrize("jax_rel", sorted(FLAG_PAIRS))
def test_jax_flags_are_port_flags(jax_rel):
    """(d) Every flag of the JAX CLI exists in the port's with the same
    default, type, action, nargs, choices, const and required, past
    FLAGS_DEPARTING (whose entries for this CLI must still depart)."""
    got = _flag_departures(_read(jax_rel), _read(FLAG_PAIRS[jax_rel]))
    rel = jax_rel[len(JAX_PKG) + 1:] if jax_rel.startswith(JAX_PKG + "/") else jax_rel
    assert {f"{rel}::{k}": v for k, v in got.items()} == {
        k: v for k, v in FLAGS_DEPARTING.items() if k.startswith(rel + "::")}
    assert _flags(_read(jax_rel)) or jax_rel.endswith(("bench.py", "noop_launch.py"))
