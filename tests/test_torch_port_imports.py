"""The port stands alone: importing every module of segmentation3d_tpu_torch
(and chip_smoke.py) loads neither jax nor any module of the JAX package."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
import segmentation3d_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "flax"
             or m.startswith("flax.") or m == "segmentation3d_tpu"
             or m.startswith("segmentation3d_tpu."))
print(",".join(names), "bad:" + ",".join(bad))
"""

#: modules each slice added, all of which must be among those imported
MODULES = ["core.seg_infer", "core.infer_engine", "core.coarse_to_fine",
           "models.vnet", "models.vbnet", "models.fused_vnet", "models.quant_vnet",
           "ops.thin_conv", "ops.window_i8", "ops.conv_plan", "ops.cuda_build",
           "cli.seg_infer", "utils.model_io"]


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr
    names, bad = res.stdout.strip().split(" ", 1)
    names = names.split(",")
    assert len(names) >= 17  # every module of the port was imported
    assert {f"segmentation3d_tpu_torch.{m}" for m in MODULES} <= set(names)
    assert bad == "bad:", f"the port pulled in: {bad}"
