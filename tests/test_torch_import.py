"""flipped_tpu_torch stands alone: importing every module of the port, and
everything chip_smoke.py imports, pulls in neither jax, flax, optax nor any
module of the JAX package `flipped_tpu` (the machine with the card has no
jax, and the port keeps its own copies of the host layers)."""
import ast
import importlib.util
import pkgutil
import subprocess
import sys
from pathlib import Path

import flipped_tpu_torch

ROOT = Path(__file__).resolve().parents[1]

CHECK = (
    "import sys\n"
    "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'optax',\n"
    "             'flipped_tpu') or m.startswith(('jax.', 'jaxlib', 'flax.',\n"
    "             'optax.', 'flipped_tpu.')))\n"
    "assert not bad, bad\n"
    "print('ok')\n")


def _is_module(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except ModuleNotFoundError:     # the parent is a module, not a package
        return False


def _run(code: str):
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_port_imports_without_jax():
    """Every module of the port, found by walking the package."""
    names = [m.name for m in pkgutil.walk_packages(
        flipped_tpu_torch.__path__, "flipped_tpu_torch.")]
    assert "flipped_tpu_torch.cli.train" in names
    assert "flipped_tpu_torch.data.pipeline" in names
    _run("".join(f"import {n}\n" for n in names) + CHECK)


def test_chip_smoke_imports_without_the_jax_package():
    """Every module chip_smoke.py imports, at top level or inside its
    functions, and the script itself."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
            # `from package import module` imports the module too
            mods.update(f"{node.module}.{a.name}" for a in node.names
                        if _is_module(f"{node.module}.{a.name}"))
    assert "flipped_tpu_torch.cli.train" in mods
    assert not any(m == "flipped_tpu" or m.startswith(("flipped_tpu.", "jax"))
                   for m in mods), mods
    assert "make_synthetic_data" not in (ROOT / "chip_smoke.py").read_text()
    _run("".join(f"import {m}\n" for m in sorted(mods))
         + "import importlib.util as u\n"
         "s = u.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
         "s.loader.exec_module(u.module_from_spec(s))\n" + CHECK)
