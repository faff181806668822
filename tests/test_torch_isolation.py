"""presto_tpu_torch stands alone: it imports neither JAX nor the
reference package, picks its device explicitly, and passes the repo's
lint gate."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from presto_tpu_torch.exec import kernels as K
from tests.torch_threads import torch_one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "presto_tpu")


def _port_sources():
    pkg = os.path.join(ROOT, "presto_tpu_torch")
    for dirpath, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_reference():
    sources = list(_port_sources())
    assert len(sources) > 20
    bad = [(os.path.relpath(p, ROOT), m) for p in sources
           for m in _imported_roots(p) if m in FORBIDDEN]
    assert not bad, bad


def test_connect_without_a_device_needs_cuda():
    import presto_tpu_torch

    if torch.cuda.is_available():
        assert presto_tpu_torch.connect().device == torch.device("cuda:0")
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        presto_tpu_torch.connect()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        presto_tpu_torch.connect(device="cuda")
    assert presto_tpu_torch.connect(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("entry", ["fused_group_sums_cuda",
                                   "fused_group_sums"])
def test_fused_group_sums_never_computes_off_cuda(entry):
    """The CUDA launcher refuses CPU tensors, and the dispatching wrapper
    takes the plain version for CPU tensors only: a tensor on any other
    device goes to the launcher, which raises instead of computing."""
    vals = torch.ones((2, 10), dtype=torch.float64)
    gid = torch.zeros((10,), dtype=torch.int32)
    if entry == "fused_group_sums":
        vals, gid = vals.to("meta"), gid.to("meta")
    before = K.fused_group_sums_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        getattr(K, entry)(vals, gid, 1)
    assert K.fused_group_sums_cuda.launches == before


def test_lint_clean():
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "lint.py"),
         os.path.join(ROOT, "presto_tpu_torch"),
         os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True)
    assert r.returncode == 0, f"lint findings:\n{r.stdout}"
