"""Guards on the PyTorch port's boundaries.

- No module of cockroach_tpu_torch, and not chip_smoke.py, imports
  jax or anything of the JAX package (an AST scan of every import).
- Entry points never quietly fall back to the CPU: without a card and
  without an explicit device, Engine() raises, and the kernel wrapper
  takes its plain version only for CPU tensors.
"""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "cockroach_tpu")


def _port_files():
    files = sorted((ROOT / "cockroach_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py"]
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_scan_covers_the_package():
    names = {p.name for p in _port_files()}
    assert {"engine.py", "compile.py", "groupagg_large.py", "groupagg.py",
            "hashtable.py", "join.py", "chip_smoke.py"} <= names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_engine_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from cockroach_tpu_torch import default_device
    from cockroach_tpu_torch.exec.engine import Engine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()


def test_wrapper_uses_plain_version_only_for_cpu_tensors():
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    n = 256
    gid = torch.zeros(n, dtype=torch.int32)
    sel = torch.ones(n, dtype=torch.bool)
    col = torch.ones(n)
    launches, plain = tgl.LAUNCHES, tgl.PLAIN_CALLS
    _, acc_i = tgl.large_group_aggregate(gid, sel, (col,), (), 1, (True,))
    assert int(acc_i[0, 0]) == n
    assert (tgl.LAUNCHES, tgl.PLAIN_CALLS) == (launches, plain + 1)
    meta = torch.zeros(n, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tgl.large_group_aggregate(meta, sel, (col,), (), 1, (True,))


def test_small_wrapper_uses_plain_version_only_for_cpu_tensors():
    from cockroach_tpu_torch.ops.cuda import groupagg as tg
    n = 256
    gid = torch.zeros(n, dtype=torch.int32)
    sel = torch.ones(n, dtype=torch.bool)
    col = torch.ones(n)
    launches, plain = tg.LAUNCHES, tg.PLAIN_CALLS
    _, cnt = tg.dense_group_aggregate(gid, sel, (col,), (sel,), 1,
                                      (tg.COUNT,))
    assert int(cnt[0, 0]) == n
    assert (tg.LAUNCHES, tg.PLAIN_CALLS) == (launches, plain + 1)
    meta = torch.zeros(n, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tg.dense_group_aggregate(meta, sel, (col,), (sel,), 1, (tg.COUNT,))
