"""The port's import isolation: ``nf_tpu_torch``, every one of its
submodules and ``chip_smoke`` import neither JAX nor any module of the
JAX package ``nf_tpu``. Checked in a fresh interpreter, whose
``sys.modules`` this test's own imports cannot fill."""

import json
import os
import subprocess
import sys

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
    assert "nf_tpu_torch.flows.residual" in result["imported"]
    assert "nf_tpu_torch.nets.lipschitz" in result["imported"]
    assert result["bad"] == []
