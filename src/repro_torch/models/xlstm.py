"""xLSTM blocks (the xlstm-350m substrate): mLSTM and sLSTM.

The port of ``repro/models/xlstm.py``.

mLSTM — matrix-memory LSTM with exponential gating; attention-free.
  Parallel form, stabilized as in the xLSTM paper:
     logD[t,s] = Σ_{j=s+1..t} log f_j + log i_s          (s ≤ t)
     m_t = max_s logD[t,s]
     S[t,s] = (q_t·k_s/√d) · exp(logD[t,s] − m_t)
     h_t = Σ_s S[t,s] v_s / max(|Σ_s S[t,s]|, exp(−m_t))
  Chunkwise form (training and prefill): the parallel form inside each
  chunk, the (C, n, m) state carried across chunks.
  Recurrent form (decode):
     C_t = f̄ C_{t−1} + ī v k^T;  n_t = f̄ n_{t−1} + ī k
     m_t = max(log f + m_{t−1}, log i);  f̄ = e^{log f + m_{t−1} − m_t}, ī = e^{log i − m_t}
     h_t = C_t q / max(|n_t·q|, exp(−m_t))

sLSTM — scalar-memory LSTM with recurrent memory mixing (block-diagonal
  per-head R matrices); sequential, a Python loop over ``_slstm_step``
  for any T (the JAX package's ``lax.scan``; it has no kernel), one step
  for decode.

The recurrences run in float32 whatever the activations' dtype, as in
the JAX package; gate biases are float32.  The mLSTM block has an
up → gate → down projection shell (factor ``proj_factor``), the sLSTM
block a gated FFN (geglu, factor 4/3); neither has a second MLP.  The
``decode`` flag, not T, picks the recurrent form: a one-token prompt
prefills chunkwise.  A state passed to a block is updated in place and
returned; ``state=None`` starts from the initial state (m at −1e30, the
sLSTM's n at 1e-6) and returns a new one.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers

_F32 = torch.float32


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, hd, hd) matrix memory
    n: torch.Tensor   # (B, H, hd) normalizer
    m: torch.Tensor   # (B, H) stabilizer


def init_mlstm_block(generator, d_model: int, num_heads: int,
                     proj_factor: float = 2.0, device=None) -> dict:
    di = int(d_model * proj_factor)
    hd = di // num_heads
    p = {"up": layers.init_dense(generator, d_model, (2 * di,), device),
         "q": layers.init_dense(generator, di, (num_heads, hd), device),
         "k": layers.init_dense(generator, di, (num_heads, hd), device),
         "v": layers.init_dense(generator, di, (num_heads, hd), device),
         "igate": layers.init_dense(generator, di, (num_heads,), device),
         "fgate": layers.init_dense(generator, di, (num_heads,), device)}
    # forget bias starts positive, so early training does not wash memory
    p["gate_bias"] = {
        "i": torch.zeros((num_heads,), dtype=_F32, device=device),
        "f": torch.full((num_heads,), 3.0, dtype=_F32, device=device)}
    p["ln_inner"] = layers.init_norm(di, "rmsnorm", device)
    p["down"] = layers.init_dense(generator, di, (d_model,), device)
    return p


MLSTM_AXES = {"up": layers.dense_axes("embed", ("mlp",)),
              **{k: layers.dense_axes("mlp", ("heads", "qkv"))
                 for k in ("q", "k", "v")},
              "igate": layers.dense_axes("mlp", ("heads",)),
              "fgate": layers.dense_axes("mlp", ("heads",)),
              "gate_bias": {"i": ("heads",), "f": ("heads",)},
              "ln_inner": layers.norm_axes("rmsnorm", "mlp"),
              "down": layers.dense_axes("mlp", ("embed",))}


def _causal_logd(clf: torch.Tensor, log_i: torch.Tensor) -> torch.Tensor:
    """(B, T, H) cumulative log f and log i -> (B, T, S, H) log decay,
    −inf above the diagonal."""
    t = clf.shape[1]
    logd = clf[:, :, None, :] - clf[:, None, :, :] + log_i[:, None, :, :]
    tri = torch.ones((t, t), dtype=torch.bool, device=clf.device).tril()
    return torch.where(tri[None, :, :, None], logd, -torch.inf)


def _mlstm_parallel(q, k, v, log_i, log_f):
    """q/k/v: (B, T, H, hd); log_i/log_f: (B, T, H) -> h: (B, T, H, hd)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logd = _causal_logd(torch.cumsum(log_f, dim=1), log_i)      # (B,T,S,H)
    m = torch.amax(logd, dim=2)                                  # (B, T, H)
    d = torch.exp(logd - m[:, :, None, :])
    s = torch.einsum("bthd,bshd->btsh", q.to(_F32) * scale, k.to(_F32)) * d
    norm = torch.maximum(torch.abs(torch.sum(s, dim=2)), torch.exp(-m))
    out = torch.einsum("btsh,bshd->bthd", s, v.to(_F32))
    return (out / norm[..., None]).to(q.dtype)


def _mlstm_chunkwise(q, k, v, log_i, log_f, state: MLSTMState,
                     chunk: int = 256):
    """Chunkwise-parallel mLSTM: O(T·chunk) memory instead of O(T²).
    q/k/v: (B, T, H, hd); log_i/log_f: (B, T, H); T % chunk == 0.
    Returns (h (B, T, H, hd) in q's dtype, the final state)."""
    b, t, h, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    st_c, st_n, st_m = state
    outs = []
    for c0 in range(0, t, chunk):
        sl = slice(c0, c0 + chunk)
        qc, kc, vc = q[:, sl].to(_F32), k[:, sl].to(_F32), v[:, sl].to(_F32)
        li, lf = log_i[:, sl], log_f[:, sl]
        clf = torch.cumsum(lf, dim=1)                            # (B, ck, H)
        logd = _causal_logd(clf, li)
        intra_max = torch.amax(logd, dim=2)                      # (B, ck, H)
        w_inter = clf + st_m[:, None, :]
        m_t = torch.maximum(intra_max, w_inter)
        d = torch.exp(logd - m_t[:, :, None, :])
        inter = torch.exp(w_inter - m_t)                         # (B, ck, H)

        qf = qc * scale
        s = torch.einsum("bthd,bshd->btsh", qf, kc) * d
        num = torch.einsum("btsh,bshd->bthd", s, vc) \
            + inter[..., None] * torch.einsum("bhij,bthi->bthj", st_c, qf)
        den_sum = torch.sum(s, dim=2) \
            + inter * torch.einsum("bhi,bthi->bth", st_n, qf)
        den = torch.maximum(torch.abs(den_sum), torch.exp(-m_t))
        outs.append(num / den[..., None])

        # end-of-chunk state
        wlog = clf[:, -1:, :] - clf + li                         # (B, ck, H)
        m_new = torch.maximum(torch.amax(wlog, dim=1), clf[:, -1] + st_m)
        wk = torch.exp(wlog - m_new[:, None, :])
        carry_scale = torch.exp(clf[:, -1] + st_m - m_new)
        st_c = torch.einsum("bsh,bshi,bshj->bhij", wk, kc, vc) \
            + carry_scale[..., None, None] * st_c
        st_n = torch.einsum("bsh,bshd->bhd", wk, kc) \
            + carry_scale[..., None] * st_n
        st_m = m_new
    hseq = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return hseq.to(q.dtype), MLSTMState(st_c, st_n, st_m)


def _mlstm_step(state: MLSTMState, q, k, v, log_i, log_f):
    """One decode step. q/k/v: (B, H, hd); log gates: (B, H)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    m_new = torch.maximum(log_f + state.m, log_i)                # (B, H)
    fbar = torch.exp(log_f + state.m - m_new)[..., None]
    ibar = torch.exp(log_i - m_new)[..., None]
    kf, vf = k.to(_F32), v.to(_F32)
    c = state.c * fbar[..., None] \
        + ibar[..., None] * vf[..., None, :] * kf[..., :, None]
    n = state.n * fbar + ibar * kf
    qf = q.to(_F32) * scale
    num = torch.einsum("bhij,bhi->bhj", c, qf)                   # (B, H, hd)
    den = torch.maximum(torch.abs(torch.einsum("bhi,bhi->bh", n, qf)),
                        torch.exp(-m_new))
    return MLSTMState(c, n, m_new), (num / den[..., None]).to(q.dtype)


def mlstm_chunk(t: int) -> int:
    """The JAX package's chunk for a T-token prefill: 256 when T > 256 and
    256 divides T, else 64 when T > 64 and 64 divides T, else T."""
    if t > 256 and t % 256 == 0:
        return 256
    if t % 64 == 0 and t > 64:
        return 64
    return t


def _write_state(state, new):
    """Copy ``new`` into a given state in place; a new state as it is."""
    if state is None:
        return new
    for dst, src in zip(state, new):
        dst.copy_(src)
    return state


def apply_mlstm_block(params: dict, x: torch.Tensor,
                      state: Optional[MLSTMState] = None,
                      decode: bool = False):
    """x: (B, T, d) -> (y, state).  decode=True requires T == 1."""
    b, t, _ = x.shape
    nh = params["igate"]["kernel"].shape[1]
    up = layers.dense(params["up"], x)
    di = up.shape[-1] // 2
    xm, z = up[..., :di], up[..., di:]
    q = layers.dense(params["q"], xm)
    k = layers.dense(params["k"], xm) / math.sqrt(q.shape[-1])
    v = layers.dense(params["v"], xm)
    log_i = (layers.dense(params["igate"], xm).to(_F32)
             + params["gate_bias"]["i"])
    log_f = F.logsigmoid(layers.dense(params["fgate"], xm).to(_F32)
                         + params["gate_bias"]["f"])
    start = state if state is not None else init_mlstm_state(
        b, nh, q.shape[-1], x.device)
    if decode:
        new, h1 = _mlstm_step(start, q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                              log_f[:, 0])
        h = h1[:, None]
    else:
        h, new = _mlstm_chunkwise(q, k, v, log_i, log_f, start,
                                  mlstm_chunk(t))
    state = _write_state(state, new)
    h = layers.apply_norm(params["ln_inner"], h.reshape(b, t, di), "rmsnorm")
    return layers.dense(params["down"], h * F.silu(z)), state


def init_mlstm_state(batch: int, num_heads: int, head_dim: int,
                     device=None) -> MLSTMState:
    return MLSTMState(
        c=torch.zeros((batch, num_heads, head_dim, head_dim), dtype=_F32,
                      device=device),
        n=torch.zeros((batch, num_heads, head_dim), dtype=_F32, device=device),
        m=torch.full((batch, num_heads), -1e30, dtype=_F32, device=device))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, hd) cell
    n: torch.Tensor   # (B, H, hd) normalizer
    h: torch.Tensor   # (B, H, hd) hidden (memory mixing input)
    m: torch.Tensor   # (B, H, hd) stabilizer


_GATES = ("z", "i", "f", "o")


def init_slstm_block(generator, d_model: int, num_heads: int,
                     ffn_factor: float = 4.0 / 3.0, device=None) -> dict:
    hd = d_model // num_heads
    p = {name: layers.init_dense(generator, d_model, (num_heads, hd), device)
         for name in ("wz", "wi", "wf", "wo")}
    # block-diagonal recurrent mixing: (4 gates, H, hd, hd)
    p["r"] = {"kernel": layers.truncated_normal_init((4, num_heads, hd, hd),
                                                     1.0, generator, device)}
    p["gate_bias"] = {
        g: torch.full((num_heads, hd), 3.0 if g == "f" else 0.0, dtype=_F32,
                      device=device) for g in ("i", "f", "z", "o")}
    p["ln_inner"] = layers.init_norm(d_model, "rmsnorm", device)
    p["ffn"] = layers.init_mlp(generator, d_model, int(d_model * ffn_factor),
                               device, "geglu")
    return p


SLSTM_AXES = {**{k: layers.dense_axes("embed", ("heads", "qkv"))
                 for k in ("wz", "wi", "wf", "wo")},
              "r": {"kernel": (None, "heads", "qkv", None)},
              "gate_bias": {g: ("heads", "qkv") for g in ("i", "f", "z", "o")},
              "ln_inner": layers.norm_axes("rmsnorm"),
              "ffn": layers.mlp_axes("geglu")}


def _slstm_gates(r: torch.Tensor, gb: torch.Tensor, state: SLSTMState,
                 x4: torch.Tensor):
    """One step on the stacked gate inputs x4 (4, B, H, hd) in z, i, f, o
    order, with r (4, H, hd, hd) and gb (4, 1, H, hd) float32: each
    gate's pre-activation is (x + mix) + bias, as in the JAX package."""
    mix = torch.einsum("bhd,ghde->gbhe", state.h, r)             # (4, B, H, hd)
    pre = x4 + mix + gb
    z = torch.tanh(pre[0])
    log_i = pre[1]
    log_f = F.logsigmoid(pre[2])
    o = torch.sigmoid(pre[3])
    m_new = torch.maximum(log_f + state.m, log_i)
    fbar = torch.exp(log_f + state.m - m_new)
    ibar = torch.exp(log_i - m_new)
    c = fbar * state.c + ibar * z
    n = torch.clamp(fbar * state.n + ibar, min=1e-6)
    h = o * c / n
    return SLSTMState(c=c, n=n, h=h, m=m_new), h


def _gate_stack(params: dict):
    r = params["r"]["kernel"].to(_F32)
    gb = torch.stack([params["gate_bias"][g] for g in _GATES])[:, None]
    return r, gb


def _slstm_step(params: dict, state: SLSTMState, xz, xi, xf, xo):
    """All inputs (B, H, hd) float32.  Returns (state, h)."""
    r, gb = _gate_stack(params)
    return _slstm_gates(r, gb, state, torch.stack([xz, xi, xf, xo]))


def apply_slstm_block(params: dict, x: torch.Tensor,
                      state: Optional[SLSTMState] = None,
                      decode: bool = False):
    """x: (B, T, d) -> (y, state).  A sequential loop over T."""
    b, t, d = x.shape
    nh, hd = params["wz"]["kernel"].shape[1:]
    x4 = torch.stack([layers.dense(params[w], x).to(_F32)
                      for w in ("wz", "wi", "wf", "wo")])     # (4, B, T, H, hd)
    st = state if state is not None else init_slstm_state(b, nh, hd,
                                                          x.device)
    r, gb = _gate_stack(params)
    hs = []
    for i in range(1 if decode else t):
        st, h = _slstm_gates(r, gb, st, x4[:, :, i])
        hs.append(h)
    state = _write_state(state, st)
    hseq = torch.stack(hs, dim=1)                                # (B, T, H, hd)
    hflat = hseq.reshape(b, -1, d).to(x.dtype)
    hflat = layers.apply_norm(params["ln_inner"], hflat, "rmsnorm")
    return hflat + layers.apply_mlp(params["ffn"], hflat, "geglu"), state


def init_slstm_state(batch: int, num_heads: int, head_dim: int,
                     device=None) -> SLSTMState:
    def z():
        return torch.zeros((batch, num_heads, head_dim), dtype=_F32,
                           device=device)
    return SLSTMState(c=z(), n=z() + 1e-6, h=z(), m=z() - 1e30)
