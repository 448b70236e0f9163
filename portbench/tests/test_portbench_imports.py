"""The benchmark loads neither JAX nor the JAX package, its reference
nothing of the program, and it reads none of the JAX package's benchmark
files."""
import ast
import os
import sys

import pytest

from portbench import harness

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "flax", "siga_tpu"}


def sources(sub: str = ""):
    top = os.path.join(PORTBENCH, sub)
    for d, _dirs, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path: str) -> set:
    """The top-level names (before the first dot, whole) that a file
    imports; a relative import as '.' plus its module."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." * node.level + (node.module or "").split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, PORTBENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, PORTBENCH))
def test_the_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "siga_tpu_torch" not in names and "portbench" not in names
    assert not {n for n in names if n.startswith(".")}, names


def test_the_harness_reads_none_of_the_jax_packages_benchmark_files():
    banned = ["bench" + ".py", "chip_smoke" + ".py", "benchmark" + "/"]
    for path in sources():
        if os.sep + "tests" + os.sep in path:
            continue
        with open(path) as f:
            text = f.read()
        assert not [b for b in banned if b in text], path


def test_the_module_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "siga_tpu_torch_lookalike", sys)
    monkeypatch.delitem(sys.modules, "siga_tpu", raising=False)
    assert "siga_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "siga_tpu.index", sys)
    assert harness.banned_modules() == ["siga_tpu"]


def test_the_port_loads_no_jax(tmp_path):
    """A process that loads the harness, its entries and the port's modules
    that the entries call holds no banned module."""
    import subprocess

    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import harness\n"
            "from portbench.entries import index\n"
            "import siga_tpu_torch.index.sa\n"
            "print(harness.banned_modules())") % os.path.dirname(PORTBENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
