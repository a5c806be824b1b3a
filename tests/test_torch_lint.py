"""Lint the port: it stands alone, and its ops name their oracles.

* No module under ``src/repro_torch/`` and not ``chip_smoke.py`` imports
  ``jax`` or anything of the JAX package ``repro``.
* Every public op in ``repro_torch.kernels.ops`` has an ``ORACLES``
  entry, and each names a function that exists in
  ``repro_torch.kernels.ref``.
* Importing the kernel modules and running them on CPU tensors never
  reaches the CUDA build.
"""

import ast
import inspect
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build, ops, ref

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__"):
            roots |= {a.value.split(".")[0] for a in node.args
                      if isinstance(a, ast.Constant) and isinstance(a.value, str)}
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_repro(path):
    assert path.exists()
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_every_op_names_an_existing_oracle():
    public = sorted(name for name, fn in vars(ops).items()
                    if inspect.isfunction(fn) and not name.startswith("_")
                    and fn.__module__ == ops.__name__)
    assert public, "ops defines no public op"
    assert sorted(ops.ORACLES) == public
    for op_name, ref_name in ops.ORACLES.items():
        assert callable(getattr(ref, ref_name, None)), \
            f"ops.{op_name} names missing oracle ref.{ref_name}"


def test_kernel_sources_present_and_hashed():
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
        assert name in _build.SIGNATURES
    assert _build.library_path("mach_decode") != _build.library_path("mach_topk")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_cpu_tensors_never_reach_the_build(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("CPU path tried to build or load a CUDA kernel")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    meta = torch.rand(3, 4, 8)
    table = torch.randint(0, 8, (4, 100), dtype=torch.int32)
    ops.mach_top1(meta, table, num_classes=100)
    for est in ("unbiased", "min", "median"):
        ops.mach_topk(meta, table, num_classes=100, k=5, estimator=est)
