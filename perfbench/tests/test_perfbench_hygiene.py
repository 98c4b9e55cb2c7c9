"""What the benchmark may import: nothing of JAX or of the JAX package
(``repro``) anywhere under ``perfbench/``, and nothing of the port
(``repro_torch``) in the reference.  Each import's top-level name is
compared whole: ``repro_torch`` begins with ``repro``."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "repro"}


def imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_reference_package(path):
    assert not imports(path) & JAX


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not imports(path) & {"repro_torch", "perfbench"}


def test_whole_names_are_compared():
    src = "import repro_torch.models\nfrom repro_torch import kernels\n"
    tmp = ast.parse(src)
    got = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import)
           else n.module.split(".")[0] for n in tmp.body}
    assert got == {"repro_torch"} and not got & JAX


def test_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    from perfbench import run
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert run.loaded_forbidden() == ["repro"]
