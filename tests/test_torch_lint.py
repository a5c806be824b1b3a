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

from repro_torch.core.hashing import inverted_table
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.mach_decode import table_from_inline

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
    # the three fused-xent families: one source each, a forward and a
    # backward launch function each (the gather backward in three: its
    # dlogits, the column order after a sort, dW; the ELL backward in its
    # dlogits and dW, around the gather library's column order), and the
    # shared epilogue header
    backward = {"dense": ["fused_xent_dense_bwd_launch"]}
    backward["gather"] = [f"fused_xent_gather_{step}_launch"
                          for step in ("dlogits", "order", "dw")]
    backward["ell"] = [f"fused_xent_ell_{step}_launch"
                       for step in ("dlogits", "dw")]
    for family in ("dense", "ell", "gather"):
        name = f"mach_fused_xent_{family}"
        assert name in _build.SOURCES
        assert set(_build.SIGNATURES[name]) == {
            f"fused_xent_{family}_fwd_launch", *backward[family]}
        source = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "mach_xent_common.cuh"' in source
        for fn in _build.SIGNATURES[name]:
            assert f"int {fn}(" in source
    assert (_build.CSRC / "mach_xent_common.cuh").exists()
    # the candidate decode: kernels 7 and 8 in one source
    assert "mach_candidates" in _build.SOURCES
    assert set(_build.SIGNATURES["mach_candidates"]) == {
        "bucket_topm_launch", "mach_candidate_topk_launch"}
    source = (_build.CSRC / "mach_candidates.cu").read_text()
    assert '#include "mach_common.cuh"' in source
    for fn in _build.SIGNATURES["mach_candidates"]:
        assert f"int {fn}(" in source
    # the LM substrate: kernel 9 (the RG-LRU scan) and kernel 10 (flash
    # attention), one source and one launch function each
    for name, replaces in (("lru_scan", "lru_scan.py::lru_scan_pallas"),
                           ("flash_attention",
                            "flash_attention.py::flash_attention_pallas")):
        assert name in _build.SOURCES
        assert set(_build.SIGNATURES[name]) == {f"{name}_launch"}
        source = (_build.CSRC / f"{name}.cu").read_text()
        assert f"int {name}_launch(" in source
        assert f"src/repro/kernels/{replaces}" in source
    assert ops.ORACLES["lru_scan"] == "lru_scan_ref"
    assert ops.ORACLES["flash_attention"] == "flash_attention_ref"


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
    # the candidate decode, both hash sources
    coeffs = torch.tensor([2654435761, 40503, 97, 12345], dtype=torch.int64)
    inline = table_from_inline(coeffs, 29, 100)
    inverted = inverted_table(inline, 8, device="cpu")
    for hash_kw in ({"table": inline},
                    {"inline_coeffs": coeffs, "inline_shift": 29}):
        for est in ("unbiased", "min", "median"):
            ops.mach_topk_candidates(meta, inverted=inverted, num_classes=100,
                                     k=5, m=3, t=2, estimator=est, **hash_kw)
    # the training ops, forward and backward
    w = torch.randn(12, 4 * 8, requires_grad=True)
    bias = torch.zeros(4 * 8, requires_grad=True)
    labels = torch.randint(0, 8, (3, 4), dtype=torch.int32)
    h = torch.randn(3, 12, requires_grad=True)
    ops.mach_fused_xent(h, w, labels, num_buckets=8, bias=bias).sum().backward()
    indptr = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    indices = torch.tensor([1, 1, 0, 11, 4], dtype=torch.int32)
    for impl in ("densify", "gather"):
        ops.mach_fused_xent_csr(indptr, indices, torch.rand(5), w, labels,
                                num_buckets=8, nnz_max=3, bias=bias,
                                sparse_impl=impl).sum().backward()
    # the LM substrate ops
    ops.lru_scan(torch.rand(2, 5, 8), torch.randn(2, 5, 8), torch.zeros(2, 8))
    q = torch.randn(1, 6, 4, 16)
    ops.flash_attention(q, torch.randn(1, 6, 2, 16), torch.randn(1, 6, 2, 16),
                        window=3)


def test_training_kernel_sources_present():
    """Kernel 3 forward and backward in one source; the backward kernels
    of 9 and 10 in sources of their own, each naming the TPU kernel whose
    gradient it is."""
    expected = {
        "mach_xent": ({"mach_xent_fwd_launch", "mach_xent_bwd_launch"},
                      "src/repro/kernels/mach_xent.py::mach_xent_pallas"),
        "lru_scan_bwd": ({"lru_scan_bwd_launch"},
                         "src/repro/kernels/lru_scan.py::lru_scan_pallas"),
        "flash_attention_bwd": (
            {"flash_attention_bwd_launch"},
            "src/repro/kernels/flash_attention.py::flash_attention_pallas"),
    }
    for name, (fns, replaces) in expected.items():
        assert name in _build.SOURCES
        assert set(_build.SIGNATURES[name]) == fns
        source = (_build.CSRC / f"{name}.cu").read_text()
        for fn in fns:
            assert f"int {fn}(" in source
        assert replaces in source
    assert ops.ORACLES["mach_xent"] == "mach_xent_ref"


def test_training_paths_on_cpu_never_reach_the_build(monkeypatch):
    """Kernel 3 and the backward of kernels 9 and 10 on CPU tensors, and
    a smoke LM's loss and gradients, run their plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel
    from repro_torch.optim import value_and_grad

    def refuse(*a, **kw):
        raise AssertionError("CPU path tried to build or load a CUDA kernel")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    logits = torch.randn(2, 3, 4, 8, requires_grad=True)
    ops.mach_xent(logits, torch.randint(0, 8, (2, 3, 4))).sum().backward()
    leaves = [torch.rand(2, 5, 8, requires_grad=True),
              torch.randn(2, 5, 8, requires_grad=True),
              torch.zeros(2, 8, requires_grad=True)]
    ops.lru_scan(*leaves).sum().backward()
    q, k, v = (torch.randn(1, 6, h, 16, requires_grad=True) for h in (4, 2, 2))
    ops.flash_attention(q, k, v, window=3).sum().backward()
    assert all(z.grad is not None for z in [logits, *leaves, q, k, v])
    model = LanguageModel(get_config("recurrentgemma-2b", smoke=True))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, 256, (2, 9), dtype=torch.int32)
    (loss, _), grads = value_and_grad(model.loss, params, {"tokens": tokens},
                                      has_aux=True)
    assert torch.isfinite(loss) and grads["mach_head"]["kernel"].abs().sum() > 0
