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
