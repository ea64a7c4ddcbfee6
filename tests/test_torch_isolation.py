"""The port stands alone: importing every ``repro_torch`` module loads
neither JAX nor any module of the JAX package ``repro``, and no source
of the port (or ``chip_smoke.py``) names them in an import."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""

_IMPORT = re.compile(r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_torch)"
                     r"|from\s+(jax|jaxlib|repro)\b(?!_torch))", re.M)


def test_importing_every_module_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("repro_torch.serving.engine", "repro_torch.launch.serve",
                "repro_torch.kernels.build", "repro_torch.weights"):
        assert mod in res["modules"]


def test_no_source_imports_jax_or_the_reference():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(REPO)) for f in files
                 if _IMPORT.search(f.read_text())]
    assert offenders == []
    # the pattern does catch what it must
    for line in ("import jax", "from jax import numpy", "import repro.core",
                 "from repro.models import mlp", "  import jaxlib"):
        assert _IMPORT.search(line), line
    assert not _IMPORT.search("from repro_torch.core import track")
