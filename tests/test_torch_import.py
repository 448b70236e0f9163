"""The PyTorch port imports, and refuses a missing CUDA, with jax blocked."""
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = r"""
import sys

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax.") or name == "jaxlib" or name.startswith("jaxlib."):
            raise ImportError("jax is blocked in this test")
        return None

sys.meta_path.insert(0, _NoJax())
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
import siga_tpu.commands.assemble_cmd
assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")], "jax imported"

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
