"""Continuous-batching serving engine: slot-scheduled MACH decode.

The port of ``repro/serving/engine.py``.  Callers build a ``Request``
(prompt, optional ``SamplingParams``, per-request ``max_new_tokens``,
optional ``on_token`` callback), ``submit()`` it, and drive the engine with
``step()`` (one scheduler tick) or ``run()`` (drain everything);
finished requests come back as ``GenerationResult``s.

The KV cache is allocated once as a pool of ``ServeConfig.num_slots``
slots.  A queued request is admitted by prefilling it alone (batch 1,
exact prompt length, no padding) and copying its caches into a free
slot; every decode step then advances the whole pool with per-slot
positions and per-row cache writes.  EOS or the request's
``max_new_tokens`` frees the slot at once, and the next queued request
is admitted into it on the following tick.  ``ServeConfig.scheduler =
"lockstep"`` keeps the chunked baseline instead: it admits only into an
empty pool and holds every finished row (as an inert greedy row) until
the whole chunk has finished.

``ServeConfig.page_size > 0`` pages the linear KV caches: one shared
pool of ``num_pages`` pages a layer with per-slot page tables, in place
of a ``max_len`` strip a slot.  Admission reserves a request's worst
case (prompt + max_new_tokens, page-rounded) up front and allocates its
prompt pages (a FIFO free list); decode appends a reserved page when a
slot's next write crosses a page boundary; a finished request returns
its pages at once.  A request whose reservation does not fit waits at
the head of the queue (``reservation_failures``).  Lockstep runs on the
contiguous layout only.

Both phases end in the same serve step: the fused streaming top-k
(kernel 2; kernels 7-8 with ``candidate_mode``) per live estimator,
then a per-row Gumbel-max pick at the row's temperature over its first
``row_top_k`` candidates.  Greedy rows ride the same step at
ε-temperature over their top-1 candidate.  With the MACH head no
(batch, V) logits exist; a model with the dense OAA head takes the
top-k of its logits, and refuses ``SamplingParams.estimator``.

Randomness is keyed per request: row i's noise at token j comes from
``numpy.random.default_rng([ServeConfig.seed, salt_i, j])``, where the
salt is odd for an explicit ``SamplingParams.seed`` and even for an
engine-assigned request id, so a request's samples depend neither on
its slot nor on its neighbours, seeded and unseeded requests never
share a stream, and greedy rows are inert.  The JAX package keys the
same way with ``fold_in``; the two draw different bits.

Caveat: MoE blocks route tokens through shared expert-capacity groups,
which couples rows — per-request bit parity holds for the dense /
recurrent / local-attention substrates.  The pooled decode step passes
every slot's row, free slots too, in slot order, as the JAX package
does; with MoE blocks that order, and what the other slots hold, is
part of a row's result, so a request's tokens need not equal a batch-1
run's.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.estimators import ESTIMATORS
from repro_torch.kernels import ops
from repro_torch.models.model import LanguageModel

_GREEDY_TEMP = 1e-6            # ε-temperature: top-1 pick == argmax

SCHEDULERS = ("continuous", "lockstep")


def _prng_salt(seed: Optional[int], rid: int) -> int:
    """Per-request stream identity: explicit seeds (odd salts) and
    engine-assigned request ids (even salts) never collide."""
    if seed is not None:
        return ((2 * seed) | 1) & 0x7FFFFFFF
    return (2 * rid) & 0x7FFFFFFF


# ---------------------------------------------------------------------------
# Typed request/response surface
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs.

    All-default means greedy (unless ``ServeConfig.temperature`` opts
    the whole engine into sampling); setting any knob opts the request
    into sampling — a ``top_k``-only request samples at temperature 1.0.
    ``top_k`` is clamped to [1, ServeConfig.top_k].  ``estimator`` picks
    the MACH score reduction (Eq. 2/7/8) for this request, greedy
    included.  ``seed`` pins the request's private random stream
    (default: keyed by the engine-assigned request id)."""
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    estimator: Optional[str] = None
    seed: Optional[int] = None


GREEDY = SamplingParams()


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.  ``on_token`` streams each generated
    token id as soon as the tick that produced it completes, the first
    one (from the prefill) included."""
    prompt: Sequence[int]
    sampling: SamplingParams = GREEDY
    max_new_tokens: Optional[int] = None     # None -> ServeConfig default
    on_token: Optional[Callable[[int], None]] = None


@dataclasses.dataclass(frozen=True)
class GenerationResult:
    request_id: int
    tokens: tuple                 # generated ids (includes EOS if hit)
    finish_reason: str            # "eos" | "length"
    prompt_len: int
    submit_step: int              # engine tick at submit()
    finish_step: int              # engine tick that produced the last token

    @property
    def latency_steps(self) -> int:
        """Scheduler ticks from submission to completion, inclusive."""
        return self.finish_step - self.submit_step + 1


@dataclasses.dataclass
class EngineMetrics:
    """Counters over the engine's lifetime (see also ``queue_depth``)."""
    num_slots: int
    decode_steps: int = 0         # pooled decode calls
    prefills: int = 0             # admissions (one per request)
    tokens_generated: int = 0     # real request tokens (free slots excluded)
    completed: int = 0
    live_slot_steps: int = 0      # Σ over decode calls of producing slots
    peak_live_slots: int = 0      # max concurrently occupied slots
    # page-pool gauges (paged engines only; zero on the contiguous path)
    num_pages: int = 0            # pool size (0 = contiguous/strip layout)
    pages_in_use: int = 0         # pages allocated+written by live slots now
    pages_reserved: int = 0       # reserved now (incl. not yet written)
    pages_peak: int = 0           # max pages_reserved over the lifetime
    reservation_failures: int = 0  # admission ticks deferred for lack of pages

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots doing useful work per decode step."""
        denom = self.decode_steps * self.num_slots
        return self.live_slot_steps / denom if denom else 0.0

    @property
    def tokens_per_decode_step(self) -> float:
        return (self.tokens_generated / self.decode_steps
                if self.decode_steps else 0.0)

    @property
    def fragmentation(self) -> int:
        """Reserved − written pages: the internal fragmentation of the
        worst-case (prompt + max_new) reservations held right now."""
        return self.pages_reserved - self.pages_in_use


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 2048           # per-request token cap (page-table span)
    num_slots: int = 8            # fixed decode-pool width
    max_new_tokens: int = 64      # default per-request cap
    eos_id: int = -1              # -1: never stop early
    temperature: Optional[float] = None   # engine-wide sampling default
    top_k: int = 50               # fused-kernel candidate cap
    seed: int = 0
    scheduler: str = "continuous"  # "continuous" | "lockstep" (baseline)
    # paged KV cache: page_size > 0 turns the linear KV caches into one
    # shared (num_pages, page_size) pool a layer with per-slot page
    # tables; num_pages = 0 derives num_slots × ceil(max_len / page_size)
    # (the contiguous layout's bytes).  page_size = 0 keeps contiguous
    # per-slot strips (required by scheduler="lockstep").
    page_size: int = 0
    num_pages: int = 0
    # decode algorithm: None | "exact" stream all V classes; an (m, t)
    # tuple routes every serve step through the count-min candidate
    # filter (cost independent of V — see ops.mach_topk_candidates)
    candidate_mode: Optional[object] = None

    @property
    def paged(self) -> bool:
        return self.page_size > 0


# ---------------------------------------------------------------------------
# The unified serve step
# ---------------------------------------------------------------------------

def gumbel_noise(seed: int, salts: Sequence[int], tok_idx: Sequence[int],
                 k: int, device) -> torch.Tensor:
    """(rows, k) float32 Gumbel draws, row i from the stream
    (seed, salts[i], tok_idx[i])."""
    rows = [np.random.default_rng([seed, int(s), int(t)]).gumbel(size=k)
            for s, t in zip(salts, tok_idx)]
    return torch.as_tensor(np.stack(rows), dtype=torch.float32, device=device)


def make_serve_step_fn(model: LanguageModel, top_k: int, candidate_mode=None):
    """One step for both phases of serving.

    ``caches=None`` selects prefill: ``tokens`` is the (1, L) prompt and
    fresh caches are built (``pos`` is ignored), their linear caches at
    ``linear_cap`` rows if given (the paged engine's page-rounded prompt
    length, so the strips reshape exactly into the reserved pages).
    Otherwise one pooled decode step: ``tokens`` is (S, 1), ``pos`` the
    per-slot absolute positions, and every row's KV write lands at its
    own cache index.

    Both phases end alike: the fused top-k candidates for each estimator
    in ``estimators`` (``est_sel`` picks one per row), then the per-row
    keyed temperature / top-k pick.  Returns ``(caches, ids)``."""

    def serve_step(params, caches, tokens, pos, seed, salts, tok_idx, temps,
                   row_k, est_sel, *, estimators: tuple, max_len: int,
                   linear_cap: Optional[int] = None):
        if caches is None:                       # ---- prefill (batch 1)
            caches, h = model.prefill(params, tokens, max_len,
                                      linear_cap=linear_cap)
        else:                                    # ---- pooled decode step
            caches, h = model.decode_step(params, caches, tokens[:, 0], pos,
                                          per_slot=True)
        cands = [model.topk_candidates(params, h, top_k, est,
                                       candidate_mode=candidate_mode)
                 for est in estimators]
        if len(cands) == 1:
            vals, idxs = cands[0]
        else:
            rows = torch.arange(h.shape[0], device=h.device)
            sel = torch.as_tensor(est_sel, device=h.device)
            vals = torch.stack([c[0] for c in cands])[sel, rows]
            idxs = torch.stack([c[1] for c in cands])[sel, rows]
        dev = h.device
        ids = model.sample_from_candidates(
            vals, idxs, gumbel_noise(seed, salts, tok_idx, top_k, dev),
            temperature=torch.as_tensor(temps, dtype=torch.float32, device=dev),
            row_top_k=torch.as_tensor(row_k, device=dev))
        return caches, ids

    return serve_step


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Slot:
    """Host-side state of one occupied decode slot."""
    req_id: int
    req: Request
    salt: int                     # PRNG identity: sampling.seed or req_id
    tokens: list                  # generated so far (first from prefill)
    pos: int                      # next absolute position (= cache index)
    temp: float
    row_k: int
    est: str
    max_new: int
    submit_step: int
    done: bool = False            # lockstep only: finished, slot held
    pages: list = dataclasses.field(default_factory=list)  # pool page ids
    reserved: int = 0             # worst-case pages reserved at admission


class ServingEngine:
    """Slot-scheduled request engine over the unified serve step.

    ``submit()`` validates and queues a ``Request`` (returns its id);
    ``step()`` runs one scheduler tick — admit queued requests into free
    slots (per-request prefill + copy), then advance the pool one decode
    step — and returns the requests that finished this tick; ``run()``
    ticks until queue and pool drain and returns all results in
    submission order."""

    def __init__(self, model: LanguageModel, params: dict, scfg: ServeConfig):
        if scfg.top_k < 1:
            raise ValueError(f"ServeConfig.top_k must be >= 1, "
                             f"got {scfg.top_k}")
        if scfg.num_slots < 1:
            raise ValueError(f"ServeConfig.num_slots must be >= 1, "
                             f"got {scfg.num_slots}")
        if scfg.scheduler not in SCHEDULERS:
            raise ValueError(f"ServeConfig.scheduler must be one of "
                             f"{SCHEDULERS}, got {scfg.scheduler!r}")
        if scfg.max_new_tokens < 1:
            raise ValueError("ServeConfig.max_new_tokens must be >= 1")
        if scfg.temperature is not None and scfg.temperature <= 0:
            raise ValueError(f"ServeConfig.temperature must be > 0 (or "
                             f"None for greedy), got {scfg.temperature}")
        if scfg.page_size < 0 or scfg.num_pages < 0:
            raise ValueError("ServeConfig.page_size / num_pages must be >= 0")
        if scfg.num_pages and not scfg.page_size:
            raise ValueError("ServeConfig.num_pages requires page_size > 0")
        if scfg.paged and scfg.scheduler == "lockstep":
            # the lockstep baseline is the contiguous-strip layout by
            # definition: a layout ablation, not a second paged scheduler
            raise ValueError("scheduler='lockstep' runs on the contiguous "
                             "cache layout; unset page_size for lockstep")
        cm = scfg.candidate_mode
        if cm not in (None, ops.CANDIDATE_EXACT) and (
                isinstance(cm, str) or len(cm) != 2):
            raise ValueError(f"ServeConfig.candidate_mode must be None, "
                             f"'exact' or an (m, t) tuple, got {cm!r}")
        self.model = model
        self.params = params
        self.scfg = scfg
        self.device = params["embed"]["embedding"].device
        if cm not in (None, ops.CANDIDATE_EXACT) and model.cfg.mach is not None:
            model.mach_inverted_table(self.device)   # build it once, now
        self._serve_step = make_serve_step_fn(model, scfg.top_k, cm)
        # the fixed slot pool — allocated once, reused for every request
        if scfg.paged:
            self._num_pages = (scfg.num_pages or scfg.num_slots
                               * -(-scfg.max_len // scfg.page_size))
            self._pool = model.init_paged_caches(
                scfg.num_slots, scfg.max_len, scfg.page_size,
                self._num_pages, device=self.device)
            # FIFO free list: pages come back in the order they were
            # freed, so allocation is a function of the request sequence
            self._free_pages: collections.deque = collections.deque(
                range(self._num_pages))
        else:
            self._num_pages = 0
            self._pool = model.init_caches(scfg.num_slots, scfg.max_len,
                                           device=self.device)
        self._slots: list = [None] * scfg.num_slots
        self._queue: collections.deque = collections.deque()
        self._next_id = 0
        self._tick = 0               # scheduler ticks (latency unit)
        self.metrics = EngineMetrics(num_slots=scfg.num_slots,
                                     num_pages=self._num_pages)

    def __repr__(self) -> str:
        m = self.metrics
        live = sum(s is not None for s in self._slots)
        body = (f"slots={live}/{self.scfg.num_slots} "
                f"queue={len(self._queue)} tick={self._tick} "
                f"completed={m.completed}")
        if self.scfg.paged:
            body += (f" pages={m.pages_in_use}/{self._num_pages}"
                     f" reserved={m.pages_reserved}"
                     f" frag={m.fragmentation} peak={m.pages_peak}"
                     f" resv_fail={m.reservation_failures}")
        return f"<ServingEngine {body}>"

    # ------------------------------------------------------------- submit
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def submit(self, request: Request) -> int:
        """Validate and enqueue; returns the request id (results carry
        it, and ``run()`` orders by it)."""
        scfg = self.scfg
        prompt = list(request.prompt)
        if not prompt:
            raise ValueError("Request.prompt must be non-empty")
        sp = request.sampling
        if sp.temperature is not None and sp.temperature <= 0:
            raise ValueError(f"SamplingParams.temperature must be > 0, "
                             f"got {sp.temperature}")
        if sp.top_k is not None and sp.top_k < 1:
            raise ValueError(f"SamplingParams.top_k must be >= 1, "
                             f"got {sp.top_k}")
        if sp.estimator is not None:
            if self.model.cfg.mach is None:
                raise ValueError("SamplingParams.estimator is a MACH-head "
                                 "knob; this model serves the OAA head")
            if sp.estimator not in ESTIMATORS:
                raise ValueError(f"SamplingParams.estimator must be one of "
                                 f"{ESTIMATORS}, got {sp.estimator!r}")
        max_new = (request.max_new_tokens
                   if request.max_new_tokens is not None
                   else scfg.max_new_tokens)
        if max_new < 1:
            raise ValueError("Request.max_new_tokens must be >= 1")
        if len(prompt) + max_new - 1 > scfg.max_len:
            raise ValueError(
                f"prompt ({len(prompt)} tokens) + max_new_tokens ({max_new}) "
                f"exceeds the slot capacity ServeConfig.max_len="
                f"{scfg.max_len}")
        if scfg.paged:
            need = self._pages_for(len(prompt) + max_new - 1)
            if need > self._num_pages:
                # no pool state could ever admit it: reject now rather
                # than block the head of the queue forever
                raise ValueError(
                    f"request needs {need} pages (worst case) but the "
                    f"pool holds {self._num_pages}; raise "
                    f"ServeConfig.num_pages or page_size")
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, request, max_new, self._tick))
        return rid

    # ----------------------------------------------------------- sampling
    def _row_knobs(self, req: Request) -> tuple:
        """(temperature, row_top_k, estimator) for one request's row: it
        samples iff it sets any knob or the engine default temperature
        is set; otherwise it rides the greedy ε-temperature top-1 path
        of its estimator's scores."""
        cfg, scfg = self.model.cfg, self.scfg
        sp = req.sampling
        est = sp.estimator or (cfg.mach.estimator if cfg.mach is not None
                               else "unbiased")
        samples = (sp.temperature is not None or sp.top_k is not None
                   or scfg.temperature is not None)
        if not samples:
            return _GREEDY_TEMP, 1, est
        t = sp.temperature if sp.temperature is not None else scfg.temperature
        t = 1.0 if t is None else t          # top_k-only request: temp 1.0
        k = sp.top_k if sp.top_k is not None else scfg.top_k
        return max(float(t), _GREEDY_TEMP), int(np.clip(k, 1, scfg.top_k)), est

    # ------------------------------------------------------ page allocator
    def _pages_for(self, tokens: int) -> int:
        return -(-tokens // self.scfg.page_size)

    def _alloc_pages(self, n: int) -> list:
        """Pop ``n`` page ids FIFO; the caller has reserved them."""
        assert len(self._free_pages) >= n, (len(self._free_pages), n)
        ids = [self._free_pages.popleft() for _ in range(n)]
        self.metrics.pages_in_use += n
        return ids

    def _release_pages(self, slot: _Slot) -> None:
        """Return a finished slot's pages (FIFO) and drop its worst-case
        reservation: the next admission sees them at once."""
        self._free_pages.extend(slot.pages)
        self.metrics.pages_in_use -= len(slot.pages)
        self.metrics.pages_reserved -= slot.reserved
        slot.pages = []
        slot.reserved = 0

    # ---------------------------------------------------------- scheduling
    def _finish(self, slot: _Slot, reason: str) -> GenerationResult:
        self.metrics.completed += 1
        return GenerationResult(
            request_id=slot.req_id, tokens=tuple(slot.tokens),
            finish_reason=reason, prompt_len=len(slot.req.prompt),
            submit_step=slot.submit_step, finish_step=self._tick)

    def _emit(self, slot: _Slot, tok: int) -> Optional[str]:
        """Record one generated token; the finish reason, if any."""
        slot.tokens.append(tok)
        self.metrics.tokens_generated += 1
        if slot.req.on_token is not None:
            slot.req.on_token(tok)
        if self.scfg.eos_id >= 0 and tok == self.scfg.eos_id:
            return "eos"
        if len(slot.tokens) >= slot.max_new:
            return "length"
        return None

    def _admit(self, finished: list) -> None:
        scfg = self.scfg
        if scfg.scheduler == "lockstep" and any(
                s is not None for s in self._slots):
            return                       # baseline: drain the whole chunk
        while self._queue and None in self._slots:
            slot_i = self._slots.index(None)
            rid, req, max_new, submit_step = self._queue[0]      # peek
            need, pages, linear_cap = 0, [], None
            if scfg.paged:
                # reserve the worst case up front, so a boundary crossing
                # mid-decode never finds the free list empty
                need = self._pages_for(len(req.prompt) + max_new - 1)
                if need > self._num_pages - self.metrics.pages_reserved:
                    # backpressure: the head of the queue waits (FIFO, no
                    # later, smaller request jumps it) for freed pages
                    self.metrics.reservation_failures += 1
                    return
            self._queue.popleft()
            temp, row_k, est = self._row_knobs(req)
            salt = _prng_salt(req.sampling.seed, rid)
            if scfg.paged:
                self.metrics.pages_reserved += need
                self.metrics.pages_peak = max(self.metrics.pages_peak,
                                              self.metrics.pages_reserved)
                pages = self._alloc_pages(self._pages_for(len(req.prompt)))
                linear_cap = len(pages) * scfg.page_size
            tokens = torch.as_tensor([list(req.prompt)], dtype=torch.int64,
                                     device=self.device)
            caches, ids = self._serve_step(
                self.params, None, tokens, None, scfg.seed, [salt], [0],
                [temp], [row_k], [0], estimators=(est,), max_len=scfg.max_len,
                linear_cap=linear_cap)
            self.metrics.prefills += 1
            slot = _Slot(req_id=rid, req=req, salt=salt, tokens=[],
                         pos=len(req.prompt), temp=temp, row_k=row_k, est=est,
                         max_new=max_new, submit_step=submit_step,
                         pages=pages, reserved=need)
            reason = self._emit(slot, int(ids[0]))
            if reason is not None:       # finished at prefill: no slot taken
                if scfg.paged:
                    self._release_pages(slot)
                finished.append(self._finish(slot, reason))
                continue
            if scfg.paged:
                self.model.insert_cache_slot_paged(
                    self._pool, caches, slot_i,
                    torch.as_tensor(pages, device=self.device))
            else:
                self.model.insert_cache_slot(self._pool, caches, slot_i)
            self._slots[slot_i] = slot

    def _decode_once(self, finished: list) -> None:
        scfg = self.scfg
        live = [s for s in self._slots if s is not None and not s.done]
        if not live:
            return
        self.metrics.peak_live_slots = max(self.metrics.peak_live_slots,
                                           len(live))
        if scfg.paged:
            # lazy page append: a slot whose next write crosses a page
            # boundary takes its next reserved page now
            for i, s in enumerate(self._slots):
                if s is None or s.done:
                    continue
                pj = s.pos // scfg.page_size
                if pj >= len(s.pages):
                    (pid,) = self._alloc_pages(1)
                    s.pages.append(pid)
                    self.model.append_cache_page(self._pool, i, pj, pid)
        estimators = tuple(sorted({s.est for s in live}))
        n = scfg.num_slots
        toks = np.zeros((n, 1), np.int64)
        pos = np.zeros((n,), np.int64)
        salts, tok_idx = [0] * n, [0] * n
        temps = [_GREEDY_TEMP] * n
        row_k, est_sel = [1] * n, [0] * n
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            toks[i, 0] = s.tokens[-1]
            pos[i] = s.pos
            if s.done:
                continue                 # lockstep hold: inert greedy row
            salts[i], tok_idx[i] = s.salt, len(s.tokens)
            temps[i], row_k[i] = s.temp, s.row_k
            est_sel[i] = estimators.index(s.est)
        self._pool, ids = self._serve_step(
            self.params, self._pool, torch.as_tensor(toks, device=self.device),
            torch.as_tensor(pos, device=self.device), scfg.seed, salts,
            tok_idx, temps, row_k, est_sel, estimators=estimators,
            max_len=scfg.max_len)
        ids = ids.cpu().tolist()
        self.metrics.decode_steps += 1
        self.metrics.live_slot_steps += len(live)
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            s.pos += 1                   # every slot's cache advanced
            if s.done:
                continue
            reason = self._emit(s, ids[i])
            if reason is None:
                continue
            finished.append(self._finish(s, reason))
            if scfg.scheduler == "lockstep":
                s.done = True            # hold until the chunk drains
            elif scfg.paged:             # free at once: next tick admits
                self._release_pages(s)
                self.model.reset_cache_slot_paged(self._pool, i, scfg.max_len)
                self._slots[i] = None
            else:
                self.model.reset_cache_slot(self._pool, i, scfg.max_len)
                self._slots[i] = None
        if scfg.scheduler == "lockstep" and all(
                s is None or s.done for s in self._slots):
            for i, s in enumerate(self._slots):
                if s is not None:
                    self.model.reset_cache_slot(self._pool, i, scfg.max_len)
                    self._slots[i] = None

    def step(self) -> list:
        """One scheduler tick: admit into free slots, advance the pool
        one decode step.  Returns the results that finished this tick."""
        finished: list = []
        self._admit(finished)
        self._decode_once(finished)
        self._tick += 1
        return finished

    def run(self) -> list:
        """Drain queue and pool; results in submission order."""
        out: list = []
        while self._queue or any(s is not None for s in self._slots):
            out.extend(self.step())
        return sorted(out, key=lambda r: r.request_id)
