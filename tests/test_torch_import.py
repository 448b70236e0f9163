"""The PyTorch port stands alone: it imports, dispatches every command, and
refuses a missing CUDA with jax and the JAX package `siga_tpu` blocked, and
no source of the port imports either."""
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Python source that makes any import of jax, jaxlib or siga_tpu (the JAX
# package) raise; run first in a child process.
BLOCKER = r"""
import sys

class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "siga_tpu"):
            raise ImportError(f"{name} is blocked in this test")
        return None

sys.meta_path.insert(0, _Blocked())
"""

_BLOCKED_IMPORT = BLOCKER + r"""
import siga_tpu_torch
import siga_tpu_torch.cli
import siga_tpu_torch.kernels
import siga_tpu_torch.ops.fm_device
import siga_tpu_torch.ops.search
import siga_tpu_torch.ops.sw
import siga_tpu_torch.commands.index_cmd
import siga_tpu_torch.commands.overlap_cmd
import siga_tpu_torch.commands.rmdup_cmd
import siga_tpu_torch.index.sa
import siga_tpu_torch.probes.gather
import siga_tpu_torch.ops.kmer_count
import siga_tpu_torch.commands.correct_cmd
import siga_tpu_torch.parallel.multihost
import siga_tpu_torch.commands.assemble_cmd
import siga_tpu_torch.native
import chip_smoke

# the CLI dispatches all ten commands (each module is imported before --help)
import contextlib, io
from siga_tpu_torch import cli
assert len(cli.PORTED) == 10, cli.PORTED
for command in cli.PORTED:
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert cli.main([command, "--help"]) == 256, command
    assert "not yet ported" not in out.getvalue(), command
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "siga_tpu")]
assert not loaded, loaded

import torch
from siga_tpu_torch.device import resolve_device
assert resolve_device("cpu") == torch.device("cpu")
if not torch.cuda.is_available():
    try:
        resolve_device("cuda")
    except RuntimeError:
        pass
    else:
        raise AssertionError("resolve_device('cuda') did not raise without CUDA")
print("OK")
"""


def test_port_imports_without_jax():
    """With jax and siga_tpu blocked: every module of the port and
    chip_smoke.py import, and all ten commands run `--help`."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stderr


def test_no_port_source_imports_jax():
    pattern = re.compile(r"^\s*(import jax|from jax|import jaxlib|from jaxlib)", re.M)
    offenders = []
    for root, _dirs, files in os.walk(os.path.join(REPO, "siga_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    if pattern.search(f.read()):
                        offenders.append(path)
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        if pattern.search(f.read()):
            offenders.append("chip_smoke.py")
    assert not offenders, offenders


_SIGA_TPU_IMPORT = re.compile(r"^\s*(from|import) siga_tpu([. ]|$)", re.M)


def test_no_port_source_imports_siga_tpu():
    """No module of the port and not chip_smoke.py imports the JAX package:
    the port keeps its own copy of every framework-free module it needs."""
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "siga_tpu_torch")):
        sources += [os.path.join(root, n) for n in files if n.endswith(".py")]
    offenders = []
    for path in sources:
        with open(path) as f:
            text = f.read()
        if _SIGA_TPU_IMPORT.search(text) or re.search(r"[\"']siga_tpu\.", text):
            offenders.append(os.path.relpath(path, REPO))
    assert len(sources) > 40 and not offenders, offenders


def test_source_scan_catches_an_import():
    """The scan above recognises each form of import it must refuse."""
    for line in ("from siga_tpu import native", "import siga_tpu",
                 "from siga_tpu.io import fastx", "    import siga_tpu.cli as c"):
        assert _SIGA_TPU_IMPORT.search(line), line
    for line in ("from siga_tpu_torch import cli", "from .io import fastx",
                 "# siga_tpu/ops/fm_device.py"):
        assert not _SIGA_TPU_IMPORT.search(line), line
