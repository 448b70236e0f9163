"""The port's copies of the JAX package's framework-free modules stay in step
with their originals.

The port keeps its own copy of every such module it needs, under the same
subpath, changed only where a file names the reference sources (by a path
that is not the port's) or where the port builds its C++ runtime.  Each copy
is held against its original in `siga_tpu`: whole files as text, and the
definitions the port's own `cli.py`, `commands/overlap_cmd.py` and
`__init__.py` share with theirs as syntax trees."""
import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORIGINAL = os.path.join(REPO, "siga_tpu")
PORT = os.path.join(REPO, "siga_tpu_torch")

# files the port holds as copies of the whole file
WHOLE = (
    "constants.py",
    "core/__init__.py", "core/coord.py", "core/dna.py", "core/logconf.py", "core/quality.py",
    "io/__init__.py", "io/asqg.py", "io/bwtio.py", "io/fastx.py", "io/sai.py",
    "index/__init__.py", "index/fm.py", "index/kmerdistr.py",
    "overlap/__init__.py", "overlap/builder.py",
    "graph/__init__.py", "graph/bigraph.py", "graph/visitors.py", "graph/search.py",
    "graph/hifi.py",
    "correct/__init__.py", "correct/kmer.py", "correct/batch.py",
    "ml/__init__.py", "ml/model.py",
    "commands/__init__.py", "commands/preprocess.py", "commands/assemble_cmd.py",
    "commands/subgraph_cmd.py", "commands/match_cmd.py", "commands/preqc_cmd.py",
    "commands/gan_cmd.py",
    "native/extractor.cpp", "native/paired.cpp",
)
# definitions the port's own module shares with the original
SHARED = {
    "__init__.py": ("__version__",),
    "cli.py": ("OPTION_TABLES", "USAGE", "DESCRIPTIONS", "parse_options", "help_text"),
    "commands/overlap_cmd.py": (
        "format_vertex_record", "write_vertex_record", "_merge_hits", "_host_hits",
    ),
}
# native/__init__.py builds its library under the port's _build/ directory
NATIVE_EDITS = (
    ('_SO = os.path.join(_DIR, "libsiga_native.so")',
     '_SO = os.path.join(os.path.dirname(_DIR), "_build", "libsiga_native.so")'),
    ("    if not os.path.exists(_SO) or os.path.getmtime(_SO) < newest_src:\n",
     "    if not os.path.exists(_SO) or os.path.getmtime(_SO) < newest_src:\n"
     "        os.makedirs(os.path.dirname(_SO), exist_ok=True)\n"),
)

# an absolute path to the reference sources becomes "reference src/"
_REFERENCE_PATH = re.compile(r"(?:/[\w.-]+)+/reference/src/")


def _read(root, rel):
    with open(os.path.join(root, rel)) as f:
        return f.read()


def _normal(text):
    return _REFERENCE_PATH.sub("reference src/", text)


def _definitions(tree):
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = node
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out[node.target.id] = node
    return out


def _without_docstring(tree):
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        body = body[1:]
    return ast.dump(ast.Module(body=body, type_ignores=[]))


@pytest.mark.parametrize("rel", WHOLE)
def test_whole_copy_matches_original(rel):
    assert _normal(_read(PORT, rel)) == _normal(_read(ORIGINAL, rel)), rel


@pytest.mark.parametrize("rel", sorted(SHARED))
def test_shared_definitions_match_original(rel):
    port = _definitions(ast.parse(_read(PORT, rel)))
    original = _definitions(ast.parse(_normal(_read(ORIGINAL, rel))))
    for name in SHARED[rel]:
        assert ast.dump(port[name]) == ast.dump(original[name]), f"{rel}: {name}"


def test_native_loader_matches_original():
    """The loader differs from its original only in where it puts the
    library (and in its docstring, which says so)."""
    text = _read(ORIGINAL, "native/__init__.py")
    for old, new in NATIVE_EDITS:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    port = ast.parse(_read(PORT, "native/__init__.py"))
    assert _without_docstring(port) == _without_docstring(ast.parse(text))


def test_every_copy_is_listed():
    """Each module of the port that has a namesake in the JAX package is one
    of the copies above, or one of the port's own modules that replaces its
    namesake's device code."""
    own = {
        "cli.py", "__init__.py", "__main__.py", "commands/overlap_cmd.py",
        "commands/correct_cmd.py", "commands/index_cmd.py", "commands/rmdup_cmd.py",
        "index/sa.py", "ops/__init__.py", "ops/fm_device.py", "ops/search.py",
        "ops/kmer_count.py", "parallel/__init__.py", "parallel/multihost.py",
        "native/__init__.py",
    }
    listed = set(WHOLE) | set(SHARED) | own
    unlisted = []
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "_build")]
        for name in files:
            rel = os.path.relpath(os.path.join(root, name), PORT)
            if name.endswith((".py", ".cpp")) and os.path.exists(os.path.join(ORIGINAL, rel)):
                if rel not in listed:
                    unlisted.append(rel)
    assert not unlisted, unlisted


def test_a_drifted_copy_is_caught():
    """The comparison sees a one-character change, and the normalisation
    takes only reference paths."""
    text = _read(ORIGINAL, "core/dna.py")
    assert _normal(text.replace("ACGT", "ACGU", 1)) != _normal(text)
    assert _normal("see /x/reference/src/a.cpp:1") == "see reference src/a.cpp:1"
    assert _normal("see siga_tpu/core/dna.py") == "see siga_tpu/core/dna.py"
