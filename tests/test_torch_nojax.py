"""cv_tpu_torch stands alone: importing it (every module) pulls in neither
JAX nor cv_tpu, no source file of it names them, and none builds a path
into the cv_tpu package (its data files, the LSH codebook included, are
the port's own copies)."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "cv_tpu_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(PKG.parent).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


def test_import_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cv_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(PKG)) for p in PKG.rglob("*.py")))
def test_source_names_no_jax(path):
    text = (PKG / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|cv_tpu)\b", text, re.M), path


@pytest.mark.parametrize("path", sorted(str(p.relative_to(PKG)) for p in PKG.rglob("*.py")))
def test_source_opens_no_path_under_cv_tpu(path):
    text = (PKG / path).read_text()
    assert not re.search(r"""(["'])cv_tpu(\1|/)""", text), path


@pytest.mark.parametrize("script", ["chip_smoke.py", "scripts/sweep_pose_blocks.py", "scripts/time_engine_calls.py"])
def test_card_scripts_leave_jax_out(script):
    """A script run on the card imports neither JAX nor cv_tpu, at import
    or in its text."""
    path = PKG.parent / script
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|cv_tpu)\b", path.read_text(), re.M), script
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({path.stem!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cv_tpu'))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(PKG.parent), str(path.parent)]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
