"""The port stands alone: every module of ``repro_torch`` and
``chip_smoke.py`` imports with ``jax`` and the JAX package blocked, and
none of them is loaded afterwards."""

import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")

PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["repro"] = None        # and so does `import repro...`
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = [n for n, m in sys.modules.items() if m is not None and (
    n.split(".")[0] in ("jax", "jaxlib", "repro"))]
print(len(names), loaded)
assert not loaded, loaded
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, loaded = out.stdout.split(" ", 1)
    assert int(n) >= 20 and loaded.strip() == "[]"


def test_chip_smoke_fails_without_a_card():
    """Without a CUDA device the smoke script exits non-zero and prints no
    result line."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
