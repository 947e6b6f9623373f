"""The port's import isolation: ``nf_tpu_torch``, every one of its
submodules and ``chip_smoke`` import neither JAX nor any module of the
JAX package ``nf_tpu``. Checked in a fresh interpreter, whose
``sys.modules`` this test's own imports cannot fill.

And its names: every public name of the JAX package's top level,
``flows``, ``distributions``, ``sampling``, ``utils``, ``parallel`` and
``ops`` has a counterpart of the same name in the port, but for the names
``ROADMAP.md`` section 1 keeps out by design or still queues (listed
below); so has every public function ``nf_tpu/compat.py`` defines."""

import importlib
import json
import os
import subprocess
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import nf_tpu_torch
names = ["nf_tpu_torch"]
for info in pkgutil.walk_packages(nf_tpu_torch.__path__, "nf_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
importlib.import_module("chip_smoke")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "nf_tpu" or m.startswith("nf_tpu."))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    for module in ("flows.residual", "nets.lipschitz", "flows.stochastic",
                   "sampling.hais", "utils.serialization", "data", "train",
                   "compat_export", "parallel.multihost"):
        assert f"nf_tpu_torch.{module}" in result["imported"]
    assert result["bad"] == []


# the JAX package's pytree module system (``nf_tpu/utils/module.py``):
# the port's modules are ``torch.nn.Module``s, by design
_BY_DESIGN = {"utils": {"Module", "buffer_field", "combine", "is_array",
                        "is_inexact_array", "partition", "partition_arrays",
                        "static_field", "stop_gradient_params",
                        "tree_size"},
              # the switch back to the dense path's autodiff: the port's
              # backward is always a kernel on the card
              "ops": {"set_pallas_bwd_enabled"}}
# names the port has yet to bring (ROADMAP.md section 1): none
_QUEUED = {}


def _public_names(module):
    """The public names a package's ``__init__.py`` binds (its imports,
    assignments and definitions), read from its source: ``dir()`` also
    lists the submodules other code happened to import."""
    import ast

    with open(module.__file__) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
    return {n for n in names if not n.startswith("_") and n != "annotations"}


@pytest.mark.parametrize("package", ["", "flows", "distributions",
                                     "sampling", "utils", "parallel",
                                     "ops"])
def test_every_public_jax_name_has_a_port_counterpart(package):
    suffix = f".{package}" if package else ""
    jax_mod = importlib.import_module("nf_tpu" + suffix)
    port = importlib.import_module("nf_tpu_torch" + suffix)
    public = _public_names(jax_mod)
    excused = _BY_DESIGN.get(package, set()) | _QUEUED.get(package, set())
    assert excused <= public, sorted(excused - public)
    missing = sorted(n for n in public - excused if not hasattr(port, n))
    assert missing == []
    for name in sorted(public - excused):
        want, got = getattr(jax_mod, name), getattr(port, name)
        assert isinstance(got, types.ModuleType) == isinstance(
            want, types.ModuleType), name


def test_every_public_jax_compat_function_has_a_port_counterpart():
    """``nf_tpu.compat`` is a module of converters: its public functions
    (not the names it imports) each have a port counterpart."""
    import ast

    jax_compat = importlib.import_module("nf_tpu.compat")
    port = importlib.import_module("nf_tpu_torch.compat")
    with open(jax_compat.__file__) as f:
        tree = ast.parse(f.read())
    public = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)
              and not n.name.startswith("_")}
    assert {"import_state_dict", "save_state_dict_npz",
            "load_state_dict_npz"} <= public
    assert sorted(n for n in public if not callable(getattr(port, n, None))
                  ) == []
