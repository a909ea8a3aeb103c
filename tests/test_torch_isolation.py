"""The port stands alone: it imports neither jax nor the JAX package."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import nerf_fusion_tpu_torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "nerf_fusion_tpu_torch"
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|nerf_fusion_tpu)(?![\w])"
    r"|import_module\(\s*['\"](?:jax|nerf_fusion_tpu)['\".]"
    r"|__import__\(\s*['\"](?:jax|nerf_fusion_tpu)['\".]", re.M)


def test_importing_the_port_loads_no_jax():
    mods = [m.name for m in pkgutil.walk_packages(nerf_fusion_tpu_torch.__path__,
                                                  "nerf_fusion_tpu_torch.")]
    assert "nerf_fusion_tpu_torch.main" in mods and len(mods) > 20
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
            " or k == 'nerf_fusion_tpu' or k.startswith('nerf_fusion_tpu.'))\n"
            "print(bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]", proc.stdout


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(REPO)) for f in files
                 if _FORBIDDEN.search(f.read_text())]
    assert offenders == []
