"""The port stands alone: no file of roitr_torch/, and not chip_smoke.py,
imports jax, flax or anything of roitr_tpu, neither in its source text nor
when every module is imported (checked in a fresh interpreter that refuses
those imports)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "roitr_tpu")


def _port_files():
    return sorted((ROOT / "roitr_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_source_imports_nothing_of_jax():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names if n.split(".")[0] in BANNED]
    assert not bad, bad


_PROBE = """
import importlib, importlib.util, pkgutil, sys
BANNED = {banned!r}
for name in [m for m in sys.modules if m.split(".")[0] in BANNED]:
    del sys.modules[name]

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("the port imported " + name)
        return None

sys.meta_path.insert(0, Refuse())
import roitr_torch
names = [m.name for m in pkgutil.walk_packages(roitr_torch.__path__, "roitr_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not loaded, loaded
print(" ".join(names))
"""

# the training path's modules, which the walk must reach like every other
TRAINING_MODULES = (
    "roitr_torch.losses", "roitr_torch.parallel.train_step", "roitr_torch.train.trainer",
    "roitr_torch.train.checkpoint", "roitr_torch.data.loader", "roitr_torch.utils.logging",
)
# data parallelism and the registration evaluation, likewise
DDP_AND_REGISTRATION_MODULES = (
    "roitr_torch.parallel.distributed", "roitr_torch.eval.ransac_torch",
    "roitr_torch.eval.registration", "roitr_torch.eval.ransac", "roitr_torch.eval.benchmark",
    "roitr_torch.eval.trajectory",
)


def test_imported_modules_hold_nothing_of_jax():
    code = _PROBE.format(banned=BANNED, smoke=str(ROOT / "chip_smoke.py"))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    imported = res.stdout.split()
    assert len(imported) >= 35  # every module of the port was imported
    assert set(TRAINING_MODULES) <= set(imported)
    assert set(DDP_AND_REGISTRATION_MODULES) <= set(imported)
