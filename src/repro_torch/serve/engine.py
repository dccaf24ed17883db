"""Slot-based continuous batching: the shared drain loop, its undrained
contract, paged-slot addressing, the admit-by-lane-copy primitives, and the
language-model engine (`ServeEngine`)."""
from __future__ import annotations

import queue
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.models import lm
from repro_torch.serve import graphed

# prompt-length bucketing: the smallest pad-to size, and the most compiled
# prefill variants kept (LRU), as in the JAX engine
PREFILL_BUCKET_MIN = 8
PREFILL_CACHE_MAX = 8


class EngineUndrained(RuntimeError):
    """`run_until_drained` hit its tick cap with work still queued/active.

    Carries what did finish (``finished``) and how many requests are still
    pending (``pending`` = queued + occupying a slot), so a partial drain
    is never mistaken for a complete one."""

    def __init__(self, finished: list, pending: int, max_ticks: int):
        # snapshot, not the engine's live list: the engine may keep
        # draining after the raise
        self.finished = list(finished)
        self.pending = pending
        self.max_ticks = max_ticks
        super().__init__(
            f"engine undrained after max_ticks={max_ticks}: "
            f"{len(finished)} request(s) finished, {pending} still pending")


def lane_scatter(lane_vs: tuple, full_vs: tuple, i: int) -> tuple:
    """Copy a single-lane state (each leaf (1, ...)) into lane ``i`` of a
    full state (each leaf (B, ...)); the lane is axis 0 of every leaf.

    Works in place: the leaves of ``full_vs`` are written, and any other
    reference to those tensors sees the write. Returns ``full_vs``."""
    with torch.no_grad():
        for lane, full in zip(lane_vs, full_vs):
            full[i:i + 1].copy_(lane)
    return full_vs


class SlotEngine:
    """Shared continuous-batching mechanics: the drain loop and its
    undrained contract, plus paged-slot addressing. Subclasses provide
    ``step() -> int`` (active slots after the tick), ``queue``, ``slots``
    (entries with a ``req`` field), ``finished``, ``B`` (lanes per page)
    and ``pages`` (slot i lives on page i // B, lane i % B)."""

    pages: int = 1

    def page_lanes(self, page: int) -> range:
        """Slot indices of one page (B contiguous lanes per page)."""
        return range(page * self.B, (page + 1) * self.B)

    def active_by_page(self) -> dict:
        """Occupied slot indices grouped by page: the dispatch work-list
        (a page with no active lane is not dispatched)."""
        out: dict = {}
        for i, s in enumerate(self.slots):
            if s.req is not None:
                out.setdefault(i // self.B, []).append(i)
        return out

    def run_until_drained(self, max_ticks: int = 10_000) -> list:
        """Tick until queue and slots are empty; returns the ``finished``
        request list. Raises `EngineUndrained` (carrying the partial
        ``finished`` list) when ``max_ticks`` engine ticks pass with work
        still pending."""
        for _ in range(max_ticks):
            n = self.step()
            if n == 0 and self.queue.empty():
                return self.finished
        if self.queue.empty() and all(s.req is None for s in self.slots):
            return self.finished
        pending = self.queue.qsize() + sum(
            1 for s in self.slots if s.req is not None)
        raise EngineUndrained(self.finished, pending, max_ticks)


# ---------------------------------------------------------------------------
# language-model serving
# ---------------------------------------------------------------------------

def probe_batch_axes(state, probe):
    """Per-leaf batch axis of a state tree, determined structurally: the
    unique axis whose extent follows the batch argument, found by comparing
    against a B+1 probe tree (made cheaply on the ``meta`` device). Probing
    stays unambiguous when B coincides with another dimension. Leaves
    without a batch axis map to None."""
    return lm.tree_map(
        lambda full, grown: next((ax for ax in range(full.dim())
                                  if full.shape[ax] != grown.shape[ax]), None),
        state, probe)


def tree_leaves(tree) -> list:
    """The tensors of a nested dict (and list) tree, in `lm.tree_map`'s
    order."""
    out: list = []
    lm.tree_map(out.append, tree)
    return out


def tree_lane_scatter(lane_tree, full_tree, axes, i: int):
    """Copy a single-lane state tree into batch lane ``i`` of the full tree
    along each leaf's batch axis (``axes`` from `probe_batch_axes`; leaves
    with axis None are shared and left untouched). The lane is cast to the
    full leaf's type, as the JAX package's ``lane_scatter`` does: a bf16
    leaf rounds a float32 lane.

    Works in place on the leaves of ``full_tree``; returns it."""
    def put(lane, full, ax):
        if ax is not None:
            with torch.no_grad():
                full.narrow(ax, i, 1).copy_(lane)
        return full
    lm.tree_map(put, lane_tree, full_tree, axes)
    return full_tree


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (T,) int
    max_new_tokens: int = 16
    eos_id: int = -1                # -1: run to max_new_tokens
    out_tokens: list = field(default_factory=list)


@dataclass
class _Slot:
    req: Optional[Request] = None
    remaining: int = 0


class ServeEngine(SlotEngine):
    """Slot-based continuous batching of a language model over a fixed
    decode batch with a pre-allocated cache, on the params' device.

    FIFO admission: a free slot takes the next request, prefills it, takes
    its first token from the prefill logits, and copies the single-lane
    cache into its lane (`tree_lane_scatter`). Each tick then runs one
    batched `lm.decode_step` for all slots (empty ones decode garbage that
    is dropped) and one device-to-host copy of the argmax tokens; per-slot
    stops are ``max_new_tokens`` and ``eos_id``.

    Prompt lengths (as in the JAX engine): an attention stack right-pads a
    prompt to its bucket, the next power of two (at least
    ``PREFILL_BUCKET_MIN``, at most ``max_len``), and prefills it with its
    true length; the prefill variant of each bucket is kept in
    ``_prefill_cache``, at most ``PREFILL_CACHE_MAX`` of them, the least
    recently used out first. A recurrent stack (RWKV, or a hybrid with
    Mamba layers) prefills at the exact length, since its state would
    integrate the padding, and so do an MLA stack and an encoder-decoder,
    as the JAX engine does; their variants are keyed by that length. An
    encoder-decoder cannot be served, as in the JAX engine: the prefill
    passes only ``tokens``, and the model's `KeyError` for the missing
    ``frames`` comes out of the first admission. A vision-stub model
    (llava) is served text-only, bucketed as a dense stack. A MoE stack
    buckets as the JAX engine does, though its padding is routed too (and
    the expert capacity grows with the bucket), so its prefill depends on
    the bucket as JAX's does; and every decode tick routes all B lanes,
    idle ones included, in one group, fed the same stale tokens and
    caches as JAX's.

    The RWKV cache starts as `lm.init_cache` makes it, with bf16
    token-shift leaves whatever the params' type, and so does a Mamba
    layer's conv window; the first decode tick replaces them with what it
    returns (the compute type): as in the JAX package, a request admitted
    before the first tick has its carry rounded to bf16 and one admitted
    later does not. The SSM and wkv states are float32 throughout; the K/V
    cache is bf16 throughout and is written in place.

    Compiled dispatch (the counterpart of JAX's ``jax.jit``): each bucket's
    prefill is one CUDA graph (`graphed.StaticPrefill`: static (1, bucket)
    token and (1,) length buffers), captured the first time the bucket is
    used; an exact-length prefill stays eager (a graph per distinct length
    would be captured for nearly every request). The first decode tick
    runs eagerly, since it changes an RWKV cache's types; the second
    captures the tick as a CUDA graph (`graphed.Graphed`) whose static
    inputs are a (B, 1) token buffer and the cache's leaves, which the
    graph updates in place, with the argmax inside it; every later tick
    replays it. On the CPU the same static-buffer code runs without a
    graph. A subclass that sets the class attribute ``_compiled`` False
    prefills and decodes eagerly (with the same buckets)."""

    _compiled = True

    def __init__(self, params, cfg, *, batch_slots: int = 4,
                 max_len: int = 256, parallel: Optional[ParallelConfig] = None):
        lm.check_family(cfg)
        self.params = params
        self.cfg = cfg
        self.B = batch_slots
        self.max_len = max_len
        self.parallel = parallel or ParallelConfig(remat="none")
        self.device = params["embed"].device
        self.slots = [_Slot() for _ in range(batch_slots)]
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self.finished: list = []
        self.cache = lm.init_cache(cfg, batch_slots, max_len,
                                   device=self.device)
        # host-resident token buffer; uploaded once per tick
        self.last_tokens = np.zeros((batch_slots, 1), np.int64)
        self._tokens = torch.zeros((batch_slots, 1), dtype=torch.int64,
                                   device=self.device)
        probe = lm.init_cache(cfg, batch_slots + 1, max_len, device="meta")
        self._batch_axes = probe_batch_axes(self.cache, probe)
        self.decode_ticks = 0
        self._decode = None               # the compiled tick, from tick 2
        self._prefill_cache: OrderedDict = OrderedDict()   # bucket -> fn
        # pad + true length is exact only where no mixer integrates the
        # padded positions into a recurrent state (RWKV, Mamba); MLA and
        # an encoder-decoder prefill at the exact length, as the JAX
        # engine does
        self._bucket_prompts = (
            cfg.rwkv is None and cfg.mla is None
            and not cfg.is_encoder_decoder
            and all(cfg.is_attention_layer(i) for i in range(cfg.n_layers)))

    def submit(self, req: Request) -> None:
        """Enqueue ``req`` for FIFO admission into a free decode lane."""
        self.queue.put(req)

    def _prefill_bucket(self, plen: int) -> int:
        """Compile-shape bucket of a prompt length: the next power of two
        (at least PREFILL_BUCKET_MIN, at most max_len) when the config
        admits pad + true-length prefill; the exact length otherwise."""
        if not self._bucket_prompts:
            return plen
        bucket = max(PREFILL_BUCKET_MIN, 1 << max(plen - 1, 0).bit_length())
        return max(plen, min(bucket, self.max_len))

    def _prefill_fn(self, bucket: int):
        """The prefill variant of ``bucket``, made on first use; the LRU
        keeps at most PREFILL_CACHE_MAX of them."""
        if bucket in self._prefill_cache:
            self._prefill_cache.move_to_end(bucket)
        else:
            self._prefill_cache[bucket] = self._make_prefill(bucket)
            while len(self._prefill_cache) > PREFILL_CACHE_MAX:
                self._prefill_cache.popitem(last=False)
        return self._prefill_cache[bucket]

    def _make_prefill(self, bucket: int):
        """``fn(tokens (1, bucket) int64 numpy, length) -> (logits,
        cache)``: a `graphed.StaticPrefill` for a bucket of a compiled
        engine, else the eager prefill."""
        def run(tokens, length):
            return lm.prefill(self.params, {"tokens": tokens}, self.cfg,
                              self.max_len, self.parallel, length=length)
        if self._compiled and self._bucket_prompts:
            return graphed.StaticPrefill(run, bucket, self.device)
        return lambda toks, n: run(torch.as_tensor(toks, device=self.device),
                                   n)

    def _prefill(self, prompt: np.ndarray):
        plen = len(prompt)
        bucket = self._prefill_bucket(plen)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :plen] = prompt
        with torch.no_grad():
            return self._prefill_fn(bucket)(toks, plen)

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.req is not None:
                continue
            # a request can finish at prefill (max_new_tokens=1, or the
            # prefill token is eos); keep draining the queue until one
            # needs decode ticks
            while not self.queue.empty():
                req = self.queue.get()
                if req.max_new_tokens <= 0:      # nothing to generate
                    self.finished.append(req)
                    continue
                logits, cache1 = self._prefill(req.prompt)
                tok = int(torch.argmax(logits[0]))
                req.out_tokens.append(tok)
                if req.max_new_tokens <= 1 or tok == req.eos_id:
                    self.finished.append(req)
                    continue
                tree_lane_scatter(cache1, self.cache, self._batch_axes, i)
                self.last_tokens[i, 0] = tok     # host write, no dispatch
                slot.req = req
                slot.remaining = req.max_new_tokens - 1
                break

    def _decode_in_place(self) -> torch.Tensor:
        """The compiled tick's body: decode ``_tokens``, write the new
        cache into the cache's leaves in place (a leaf the decode step
        updated in place, the K/V cache, is not copied), return the argmax
        tokens."""
        logits, cache = lm.decode_step(self.params, self._tokens, self.cache,
                                       self.cfg, self.parallel)
        for dst, src in zip(tree_leaves(self.cache), tree_leaves(cache)):
            if src is dst:
                continue
            if dst.dtype != src.dtype:
                raise TypeError(f"decode changed a cache leaf from "
                                f"{dst.dtype} to {src.dtype}")
            dst.copy_(src)
        return torch.argmax(logits, dim=-1)

    def _decode_tick(self) -> np.ndarray:
        """One batched decode of ``last_tokens``: eager on the first tick
        (on every tick when uncompiled), then the compiled tick. Returns
        the (B,) next tokens on the host."""
        self._tokens.copy_(torch.from_numpy(self.last_tokens))
        if not self._compiled or self.decode_ticks == 0:
            with torch.no_grad():
                logits, self.cache = lm.decode_step(
                    self.params, self._tokens, self.cache, self.cfg,
                    self.parallel)
                next_tokens = torch.argmax(logits, dim=-1)
        else:
            if self._decode is None:
                self._decode = graphed.Graphed(
                    self._decode_in_place, self.device,
                    keep=tuple(tree_leaves(self.cache)))
            next_tokens = self._decode()
        self.decode_ticks += 1
        return next_tokens.cpu().numpy()

    def step(self) -> int:
        """One engine tick: admit + batched decode. Returns #active slots."""
        self._admit()
        if all(s.req is None for s in self.slots):
            return 0
        next_tokens = self._decode_tick()
        for i, slot in enumerate(self.slots):
            if slot.req is None:
                continue
            tok = int(next_tokens[i])
            slot.req.out_tokens.append(tok)
            slot.remaining -= 1
            self.last_tokens[i, 0] = tok         # host write, no dispatch
            if slot.remaining <= 0 or tok == slot.req.eos_id:
                self.finished.append(slot.req)
                self.slots[i] = _Slot()
        return sum(1 for s in self.slots if s.req is not None)
