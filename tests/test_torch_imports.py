"""The port stands alone: every ``repro_torch`` module imports with JAX
and the JAX package blocked, and no port file (nor ``chip_smoke.py`` and
``tools/*.py``) names either in an import."""
import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT / "src").with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def test_every_port_module_imports_without_jax():
    mods = list(_port_modules())
    assert "repro_torch.serve.dlrm" in mods and "repro_torch.kernels.ops" in mods
    for lm_slice in ("repro_torch.models.lm", "repro_torch.models.layers",
                     "repro_torch.models.config", "repro_torch.configs",
                     "repro_torch.kernels.flash_attention", "repro_torch.serve.engine",
                     "repro_torch.launch.serve", "repro_torch.launch.mesh",
                     "repro_torch.launch.shapes", "repro_torch.launch.steps",
                     "repro_torch.configs.command_r_35b", "repro_torch.shard"):
        assert lm_slice in mods
    code = (
        "import importlib, sys\n"
        "for blocked in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[blocked] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules if sys.modules[k])\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imported_names(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_file_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    files += sorted(ROOT.glob("tools/*.py"))
    bad = [
        (str(f.relative_to(ROOT)), name)
        for f in files
        for name in _imported_names(f)
        if name.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert not bad
