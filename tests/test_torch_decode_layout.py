"""The decode wrappers' choice of kernel path and launch parameters,
computed in Python on any host (the kernels themselves run only on the
card, ``tests/test_torch_cuda.py``).

Kernel 1 (``mach_decode.decode_layout``): query per lane from N = 32
wherever 32 queries' R·B values fit in shared memory transposed (64
queries a block when N > 32 and they fit; K split for one wave), else
class per thread (K split for two waves); at least 1,024 classes a split.
Kernel 7 (``mach_candidates.topm_layout``): select for m <= 32 above
B = 1,024, and at B <= 1,024 where next_pow2(m) <= next_pow2(B) / 32 and
B > 32; else a warp sort for B <= 1,024 and a block sort above.  Kernel 2
(``mach_topk.topk_layout``): query per lane from N = 32 where
next_pow2(k) <= 32 and the tile fits, except the median in table mode,
else class per thread.  Kernel 8
(``mach_candidates.cand_layout``): blocks a query, keys a lane, and
whether the probabilities sit in shared memory; a query's partial keys
stay within the merge kernel's 4,096.  The wrappers' copies of csrc
constants and enums are read against the sources.  Shapes: ODP (R=25,
B=32, K=105,033), ImageNet-21k (R=20, B=512, K=21,841), the LM head
(R=8, B=2,048, K=256,000), the JAX gate (R=16, B=8,192, K=1,048,576) and
a collide shape (R=4, B=2, K=5,003), on an H100's 132 SMs.
"""

import re
from pathlib import Path

import pytest

from repro_torch.kernels import mach_candidates as mc
from repro_torch.kernels import mach_decode as md
from repro_torch.kernels import mach_topk as mt

SMS = 132
SHAPES = {"odp": (25, 32, 105033), "imagenet21k": (20, 512, 21841),
          "lm_head": (8, 2048, 256000), "gate": (16, 8192, 1048576),
          "collide": (4, 2, 5003)}
LANE, THREAD = "query_per_lane", "class_per_thread"

# (shape, N) -> (mapping, queries a block, splits, shared-memory bytes)
DECODE = {
    ("odp", 1): (THREAD, 1, 103, 3200),
    ("odp", 4): (THREAD, 4, 103, 12800),
    ("odp", 31): (THREAD, 8, 66, 25600),
    ("odp", 32): (LANE, 32, 103, 801 * 33 * 4),
    ("odp", 33): (LANE, 64, 103, 801 * 66 * 4),
    ("odp", 37): (LANE, 64, 103, 801 * 66 * 4),
    ("odp", 256): (LANE, 64, 33, 801 * 66 * 4),
    ("imagenet21k", 1): (THREAD, 1, 22, 40960),
    ("imagenet21k", 4): (THREAD, 4, 22, 163840),
    ("imagenet21k", 37): (THREAD, 5, 22, 204800),
    ("imagenet21k", 256): (THREAD, 5, 6, 204800),
    ("lm_head", 1): (THREAD, 1, 250, 65536),
    ("lm_head", 4): (THREAD, 3, 132, 196608),
    ("lm_head", 37): (THREAD, 3, 21, 196608),
    ("lm_head", 256): (THREAD, 3, 4, 196608),
    ("collide", 1): (THREAD, 1, 5, 32),
    ("collide", 4): (THREAD, 4, 5, 128),
    ("collide", 37): (LANE, 64, 5, 16 * 64 * 8),
    ("collide", 256): (LANE, 64, 5, 16 * 64 * 8),
}


@pytest.mark.parametrize("shape,n", sorted(DECODE), ids=str)
def test_decode_layout(shape, n):
    r, b, k = SHAPES[shape]
    want = md.DecodeLayout(*DECODE[shape, n])
    assert md.decode_layout(n, r, b, k, SMS) == want


@pytest.mark.parametrize("n", [1, 4, 37, 256])
def test_decode_layout_refuses_the_gate_shape(n):
    r, b, k = SHAPES["gate"]
    with pytest.raises(ValueError, match="do not fit"):
        md.decode_layout(n, r, b, k, SMS)


@pytest.mark.parametrize("n", [1, 4])
def test_lm_head_decode_keeps_class_per_thread(n):
    """The LM engine's direct greedy loop (N = 1 after a prefill, N = 4
    in the pooled decode) stays on the class-per-thread kernel."""
    r, b, k = SHAPES["lm_head"]
    assert md.decode_layout(n, r, b, k, SMS).mapping == THREAD


def test_decode_threshold_is_a_warp_of_queries():
    r, b, k = SHAPES["odp"]
    mappings = [md.decode_layout(n, r, b, k, SMS).mapping
                for n in range(1, 70)]
    assert mappings == [THREAD] * 31 + [LANE] * 38
    lay = md.decode_layout(256, r, b, k, SMS)
    assert lay.smem_bytes <= md._SMEM_OPTIN
    assert -(-256 // lay.queries) * lay.splits == SMS         # one wave


# (B, m) -> (path, keys)
TOPM = {
    (32, 32): ("warp", 1),               # ODP exact
    (32, 2): ("warp", 1),                # ODP approximate: B <= 32, a warp
    (32, 31): ("warp", 1),
    (512, 512): ("warp", 16),            # ImageNet-21k exact
    (512, 4): ("select", 4),             # ImageNet-21k approximate
    (512, 16): ("select", 16),
    (512, 32): ("warp", 16),             # a list of 32 > 16 keys a lane
    (512, 33): ("warp", 16),
    (2048, 2048): ("block", 2048),       # the LM engine's (2048, 8)
    (2048, 16): ("select", 16),          # the LM engine's (16, 2)
    (8192, 12): ("select", 16),          # the JAX gate
    (8192, 8191): ("block", 8192),
    (4, 4): ("warp", 1),                 # collide exact
    (4, 3): ("warp", 1),
    (4, 1): ("warp", 1),
    (37, 1): ("select", 1),
    (37, 2): ("select", 2),
    (37, 3): ("warp", 2),
    (37, 33): ("warp", 2),
    (37, 37): ("warp", 2),
    (64, 2): ("select", 2),
    (64, 4): ("warp", 2),
    (128, 8): ("warp", 4),
    (256, 8): ("select", 8),
    (256, 12): ("warp", 8),
    (1000, 32): ("select", 32),
    (1000, 999): ("warp", 32),
    (1024, 12): ("select", 16),
    (1024, 1024): ("warp", 32),
    (1025, 12): ("select", 16),
    (1025, 1025): ("block", 2048),
    (16384, 33): ("block", 16384),
    (30000, 32): ("select", 32),         # select takes any B
}


@pytest.mark.parametrize("b,m", sorted(TOPM), ids=str)
def test_topm_layout(b, m):
    assert mc.topm_layout(b, m) == mc.TopmLayout(*TOPM[b, m])


@pytest.mark.parametrize("b,m", [(30000, 33), (5, 0), (5, 6)])
def test_topm_layout_refuses(b, m):
    with pytest.raises(ValueError):
        mc.topm_layout(b, m)


# (shape, N, k) -> (mapping, queries a block, splits, list length, shared
# memory bytes)
TOPK = {
    ("odp", 256, 10): (LANE, 64, 33, 16, 801 * 66 * 4),     # the main path
    ("odp", 256, 1): (LANE, 64, 33, 1, 801 * 66 * 4),
    ("odp", 256, 32): (LANE, 32, 17, 32, 8 * 32 * 16 * 32),
    ("odp", 256, 33): (THREAD, 4, 5, 0, 4 * (3200 + 4096)),
    ("odp", 256, 100): (THREAD, 4, 5, 0, 4 * (3200 + 4096)),
    ("odp", 37, 10): (LANE, 64, 103, 16, 801 * 66 * 4),
    ("odp", 33, 10): (LANE, 64, 103, 16, 801 * 66 * 4),
    ("odp", 32, 10): (LANE, 32, 103, 16, 801 * 33 * 4),
    ("odp", 31, 10): (THREAD, 4, 33, 0, 4 * (3200 + 4096)),
    ("odp", 1, 10): (THREAD, 1, 103, 0, 3200 + 4096),
    ("imagenet21k", 256, 10): (THREAD, 4, 5, 0, 4 * (40960 + 4096)),
    ("imagenet21k", 37, 10): (THREAD, 4, 22, 0, 4 * (40960 + 4096)),
    ("lm_head", 1, 50): (THREAD, 1, 64, 0, 65536 + 4096),
    ("lm_head", 4, 50): (THREAD, 3, 64, 0, 3 * (65536 + 4096)),
    ("lm_head", 4, 1): (THREAD, 3, 132, 0, 3 * (65536 + 4096)),
    ("collide", 37, 10): (LANE, 64, 5, 16, 8 * 64 * 16 * 16),
}


# (shape, N, k) -> the median's layout in table mode where it differs from
# TOPK's: class per thread, whose kernel was faster there (2.20 against
# 2.58 ms at ODP, N = 256, k = 10, on an H100)
TOPK_MEDIAN_TABLE = {
    ("odp", 256, 10): (THREAD, 4, 5, 0, 4 * (3200 + 4096)),  # the main path
    ("odp", 256, 1): (THREAD, 4, 5, 0, 4 * (3200 + 4096)),
    ("odp", 256, 32): (THREAD, 4, 5, 0, 4 * (3200 + 4096)),
    ("odp", 37, 10): (THREAD, 4, 27, 0, 4 * (3200 + 4096)),
    ("odp", 33, 10): (THREAD, 4, 30, 0, 4 * (3200 + 4096)),
    ("odp", 32, 10): (THREAD, 4, 33, 0, 4 * (3200 + 4096)),
    ("collide", 37, 10): (THREAD, 4, 5, 0, 4 * (32 + 4096)),
}


@pytest.mark.parametrize("shape,n,k", sorted(TOPK), ids=str)
def test_topk_layout(shape, n, k):
    """TOPK's layout for every estimator and both hash sources, but the
    median in table mode, which keeps class per thread."""
    r, b, num_classes = SHAPES[shape]
    want = mt.TopkLayout(*TOPK[shape, n, k])
    assert mt.topk_layout(n, r, b, num_classes, k, SMS) == want
    median_table = mt.TopkLayout(*TOPK_MEDIAN_TABLE.get((shape, n, k), want))
    assert median_table.mapping == THREAD
    for estimator in ("unbiased", "min", "median"):
        for inline in (False, True):
            expect = median_table if (estimator, inline) == ("median", False) \
                else want
            assert mt.topk_layout(n, r, b, num_classes, k, SMS, estimator,
                                  inline) == expect


@pytest.mark.parametrize("shape,n,k", [("lm_head", 1, 50), ("lm_head", 4, 50),
                                       ("lm_head", 4, 1), ("imagenet21k", 256, 10),
                                       ("odp", 256, 100), ("odp", 256, 33),
                                       ("odp", 31, 10)], ids=str)
def test_topk_layout_keeps_class_per_thread(shape, n, k):
    """The LM head's N = 1 / 4, ImageNet-21k's R·B = 10,240 and k > 32
    stay on the class-per-thread kernel."""
    r, b, num_classes = SHAPES[shape]
    assert mt.topk_layout(n, r, b, num_classes, k, SMS).mapping == THREAD


def _lane_instances() -> set:
    """(queries a block, list length) of the query-per-lane kernels that
    ``launch_lane_len`` instantiates."""
    text = (CSRC / "mach_topk.cu").read_text()
    body = text[text.index("cudaError_t launch_lane_len("):]
    body = body[:body.index("#undef MACH_LANE")]
    found = set()
    for length, v2, v1 in re.findall(
            r"list_len == (\d+)\) return two \? MACH_LANE\((\d), \d+\) : "
            r"MACH_LANE\((\d), \d+\)", body):
        found |= {(32 * int(v2), int(length)), (32 * int(v1), int(length))}
    for length, v1 in re.findall(
            r"list_len == (\d+) && !two\) return MACH_LANE\((\d), \d+\)",
            body):
        found.add((32 * int(v1), int(length)))
    return found


def test_topk_layout_picks_instantiated_lane_kernels():
    """Every query-per-lane layout, over N and k <= 32, names a (queries,
    list length) that the source instantiates, and holds k."""
    have = _lane_instances()
    assert have == {(32, 1), (64, 1), (32, 16), (64, 16), (32, 32)}
    assert set(mt._LANE_LISTS) == {length for _, length in have}
    # the median with the table hash has no lane kernel, and is never
    # given one
    assert "if constexpr (kEst == kMedian && !kInline)" in \
        (CSRC / "mach_topk.cu").read_text()
    r, b, num_classes = SHAPES["odp"]
    for n in (32, 256):
        for k in (1, 10, 32):
            assert mt.topk_layout(n, r, b, num_classes, k, SMS, "median",
                                  inline=False).mapping == THREAD
    for shape in ("odp", "collide"):
        r, b, num_classes = SHAPES[shape]
        for n in (32, 33, 64, 256):
            for k in range(1, 33):
                lay = mt.topk_layout(n, r, b, num_classes, k, SMS)
                assert lay.mapping == LANE
                assert (lay.queries, lay.list_len) in have
                assert lay.list_len >= mt._next_pow2(k)
                assert lay.smem_bytes <= md._SMEM_OPTIN


# (R, B, m, L) of kernel 8's settings on the main paths
CAND = {
    "odp exact": (25, 32, 32, 3328), "odp approx": (25, 32, 2, 3328),
    "imagenet21k exact": (20, 512, 512, 128),
    "imagenet21k approx": (20, 512, 4, 128),
    "lm exact (2048, 8)": (8, 2048, 2048, 256),
    "lm approx (16, 2)": (8, 2048, 16, 256),
    "gate": (16, 8192, 12, 256),
}


@pytest.mark.parametrize("k", [1, 10, 50, 100, 128])
@pytest.mark.parametrize("n", [1, 4, 256])
@pytest.mark.parametrize("setting", sorted(CAND))
def test_cand_layout_keeps_partials_within_the_merge(setting, n, k):
    r, b, m, ell = CAND[setting]
    lay = mc.cand_layout(n, r, b, m, ell, k, SMS)
    assert lay.splits >= 1 and lay.splits * lay.kcap <= 4096
    assert lay.kcap == mt._next_pow2(k) and lay.kcap <= 32 * lay.lane_keys
    assert lay.lane_keys == (1 if lay.kcap <= 32 else 4)
    assert lay.smem_bytes <= md._SMEM_OPTIN
    chunks = m if m == b else r * m
    assert lay.splits <= max(1, -(-chunks // 8))      # every warp has a chunk


# setting, N, k -> (splits, kcap, lane keys, probabilities in shared memory,
# shared-memory bytes)
CAND_LAYOUT = {
    ("odp exact", 256, 10): (2, 16, 1, True, 2048 + 3200),   # one wave
    ("odp approx", 256, 10): (2, 16, 1, True, 2048 + 3200),
    ("odp exact", 5, 100): (4, 128, 4, True, 8192 + 3200),   # 32 chunks
    ("imagenet21k exact", 256, 10): (2, 16, 1, True, 2048 + 40960),
    ("imagenet21k approx", 256, 10): (2, 16, 1, True, 2048 + 40960),
    ("lm exact (2048, 8)", 4, 50): (64, 64, 4, True, 8192 + 65536),  # merge
    ("lm approx (16, 2)", 4, 50): (16, 64, 4, True, 8192 + 65536),   # chunks
    ("gate", 8, 10): (24, 16, 1, False, 2048),               # 192 chunks
}


@pytest.mark.parametrize("setting,n,k", sorted(CAND_LAYOUT), ids=str)
def test_cand_layout(setting, n, k):
    r, b, m, ell = CAND[setting]
    want = mc.CandLayout(*CAND_LAYOUT[setting, n, k])
    assert mc.cand_layout(n, r, b, m, ell, k, SMS) == want


def test_cand_layout_refuses_k_past_the_kernel():
    with pytest.raises(ValueError):
        mc.cand_layout(4, 25, 32, 32, 3328, 129, SMS)


# ---------------------------------------------------------------------------
# The wrappers' copies of csrc constants and enums, read from the sources
# ---------------------------------------------------------------------------

CSRC = Path(md.__file__).resolve().parent / "csrc"


def _csrc_int(source: str, name: str) -> int:
    """A ``constexpr int`` of ``source``: a number, or ``kOther / number``
    with kOther defined in the same file."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);",
                     (CSRC / source).read_text()).group(1).split("/")
    head = expr[0].strip()
    value = int(head) if head.isdigit() else _csrc_int(source, head)
    return value // int(expr[1]) if len(expr) == 2 else value


def _csrc_enum(source: str, name: str) -> list[str]:
    body = re.search(rf"enum {name} : int \{{([^}}]+)\}}",
                     (CSRC / source).read_text()).group(1)
    pairs = [item.split("=") for item in body.split(",")]
    return [key.strip() for key, value in sorted(pairs, key=lambda p: int(p[1]))]


@pytest.mark.parametrize("python,source,name", [
    (md.MAX_R, "mach_common.cuh", "kMaxR"),
    (md._MAX_QUERIES, "mach_decode.cu", "kMaxQueries"),
    (md._LANE_WARPS, "mach_decode.cu", "kLaneWarps"),
    (mt.MAX_K, "mach_topk.cu", "kMaxK"),
    (mt._MAX_QUERIES, "mach_topk.cu", "kMaxQueriesTopk"),
    (mt._LANE_WARPS, "mach_topk.cu", "kTopkLaneWarps"),
    (mc.MAX_KCAP, "mach_candidates.cu", "kMaxKCand"),
    (mc._CAND_WARPS, "mach_candidates.cu", "kCandWarps")], ids=str)
def test_python_constants_match_csrc(python, source, name):
    assert python == _csrc_int(source, name)


@pytest.mark.parametrize("python,source,enum,prefix", [
    (md.MAPPINGS, "mach_decode.cu", "Mapping", "k"),
    (md.MAPPINGS, "mach_topk.cu", "Mapping", "k"),
    (mc.TOPM_PATHS, "mach_candidates.cu", "TopmPath", "kTopm")], ids=str)
def test_python_enums_match_csrc(python, source, enum, prefix):
    names = [key[len(prefix):] for key in _csrc_enum(source, enum)]
    assert [n.replace("_", "") for n in python] == [n.lower() for n in names]
