"""Import hygiene of the PyTorch port: ``repro_torch`` and ``chip_smoke.py``
load neither JAX nor any module of the reference package ``repro``."""
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PKG = os.path.join(SRC, "repro_torch")

# an import of jax/jaxlib or of the reference package (``repro`` exactly,
# or ``repro.<sub>``) — ``repro_torch`` itself must not match
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|,|$)", re.M)


def _port_modules():
    mods = []
    for dirpath, _dirs, files in os.walk(PKG):
        for fn in sorted(files):
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, fn), SRC)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")] if mod.endswith("__init__")
                            else mod)
    return sorted(mods)


def test_import_loads_no_jax_and_no_reference_package():
    """Import every port module in a fresh interpreter, then look at
    ``sys.modules`` by exact name."""
    mods = _port_modules()
    assert "repro_torch.core.dynamic" in mods and len(mods) > 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'jaxlib', 'repro')"
        " or n.startswith(('jax.', 'jaxlib.', 'repro.')))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_sources_name_no_jax_or_reference_import():
    """No source line of the port or of ``chip_smoke.py`` imports JAX or
    ``repro``, not even lazily inside a function."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(PKG):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    offenders = []
    for p in paths:
        with open(p) as f:
            for m in _FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(p, REPO)}: {m.group(0).strip()}")
    assert not offenders, offenders
    assert _FORBIDDEN.search("from repro.core import x")
    assert not _FORBIDDEN.search("from repro_torch.core import x")
