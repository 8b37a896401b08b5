"""Continuous-batching chat serving: /v1/mmc feeds the slot engine (the
port's `emu_tpu/serving/continuous_helper.py`).

Drop-in for `serving.Helper` on the chat route (≙ the reference Helper
replica pool it supersedes, Emu2/demo/backend/pytorch_model/backend.py:
55-93). Instead of one whole `generate` call per checked-out replica,
every request is admitted into a slot of ONE `generation.continuous.
ContinuousEngine`: a dispatcher thread prefills new requests into free
slots between decode steps and retires finished ones immediately, so a
3-token request never queues behind a 512-token one (no head-of-line
blocking — asserted by tests/test_serving.py over real HTTP).

Continuous mode decodes greedily by default; with
`per_request_sampling=True` the engine keeps a per-slot temperature
plane and each request's `do_sample`/`temperature` form fields apply to
its own rows (greedy rows in the same pool stay exactly greedy).
Per-request beam search still doesn't apply — requests that need beams
belong on the plain Helper/Batching backends.

Speculative decoding is opt-in per request (`speculative=true` form
field): text-only prompts run draft-propose + single-pass target-verify
(`generation.speculative`) on a side thread — output provably identical
to the engine's greedy stream — and prompts with images fall back to the
slot engine.

Each request routed to the engine is a "request" record of
`profiling.RECORDER`, opened when it is queued; the dispatcher marks when
it admits it ("admitted") and the engine when its first and last tokens
are made. Each admission burst is a "helper.admit" record with its size
("burst"). `GET /v1/stats` reads them.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

from emu_tpu_torch.utils.profiling import RECORDER

logger = logging.getLogger("emu_tpu_torch.serving")


def _text_only(inputs: List) -> bool:
    flat = []
    for x in inputs:
        (flat.extend if isinstance(x, list) else flat.append)(x)
    return all(isinstance(x, str) for x in flat)


class ContinuousChatHelper:
    """Helper-compatible pool facade over one ContinuousEngine."""

    def __init__(self, pipeline, *, max_slots: int = 8, max_len: int = 512,
                 draft: Optional[Tuple[dict, object]] = None,
                 spec_k: int = 4, poll_s: float = 0.05,
                 kv_cache_quant: bool = False,
                 chunk_size: Optional[int] = None, block_steps: int = 8,
                 per_request_sampling: bool = False):
        from emu_tpu_torch.generation.continuous import ContinuousEngine
        self.pipeline = pipeline
        tok = pipeline.tokenizer
        self.engine = ContinuousEngine(
            pipeline.params["decoder"], pipeline.cfg.llama,
            max_slots=max_slots, max_len=max_len,
            eos_token_id=tok.eos_token_id,
            kv_cache_quant=kv_cache_quant, chunk_size=chunk_size,
            per_request_sampling=per_request_sampling)
        # block_steps > 1: decode in step_block blocks with the read of
        # block i overlapping block i+1 (one host round-trip per
        # block_steps tokens). Costs at most block_steps-1 idle steps per
        # retiring slot; 1 restores the per-step loop.
        self.block_steps = max(1, int(block_steps))
        self.draft = draft                  # (params, LlamaConfig) or None
        self.spec_k = spec_k
        self.poll_s = poll_s
        self.pending: "queue.Queue" = queue.Queue()
        self.waiting: Dict[int, Future] = {}
        self._stop = False
        self._thread = threading.Thread(target=self._dispatch, daemon=True)
        self._thread.start()

    # Helper-compatible interface ------------------------------------------

    def get(self):
        return _Proxy(self)

    def put(self, proxy):
        pass

    def shutdown(self):
        self._stop = True
        self._thread.join(timeout=5)

    def close(self):
        """Stop the dispatcher and release the engine's KV cache."""
        self.shutdown()
        self.engine.close()

    # dispatcher ------------------------------------------------------------

    def _admit(self, items):
        """Admit an arrival burst in ONE batched prefill program
        (submit_many: deferred first-token fetch, one dispatch per
        prompt bucket). A request that fails to embed or that the engine
        cannot admit (`check_request`) fails only its own future."""
        t_admit = time.monotonic()
        with RECORDER.span("helper.admit") as burst:
            if burst is not None:
                burst.counts["burst"] = len(items)
            rows, temps, futs, records = [], [], [], []
            for fut, inputs, kwargs, *rec in items:
                record = rec[0] if rec else None
                if record is not None:
                    record.marks["admitted"] = t_admit
                try:
                    embeds, mask, _ = self.pipeline.embed_inputs(
                        inputs, kwargs.get("is_grounding", False))
                    temp = None
                    if self.engine.per_request_sampling:
                        temp = (float(kwargs.get("temperature", 0.7))
                                if kwargs.get("do_sample") else 0.0)
                    row = (embeds, mask,
                           int(kwargs.get("max_new_tokens", 10)), temp)
                    # the one admission check: fails this future only
                    temps.append(self.engine.check_request(*row))
                    rows.append(row)
                    futs.append(fut)
                    records.append(record)
                except Exception as ex:  # noqa: BLE001
                    fut.set_exception(ex)
            if not rows:
                return
            try:
                rids = self.engine.submit_many(rows, temps, records=records)
            except Exception as ex:  # noqa: BLE001
                for fut in futs:
                    fut.set_exception(ex)
                return
        for rid, fut in zip(rids, futs):
            self.waiting[rid] = fut

    def _resolve_finished(self):
        for rid, toks in self.engine.finished().items():
            fut = self.waiting.pop(rid, None)
            if fut is not None:
                fut.set_result(self.pipeline.tokenizer.decode(
                    toks, skip_special_tokens=True))

    def _fail_all(self, ex: Exception):
        """An engine step died: fail every in-flight future loudly
        (rather than letting clients block to their 600 s timeout) and
        keep the dispatcher alive for subsequent requests."""
        logger.error("continuous dispatcher step failed: %s", ex,
                     exc_info=True)
        for rid, fut in list(self.waiting.items()):
            if not fut.done():
                fut.set_exception(ex)
            self.waiting.pop(rid, None)
        self.engine.requests.clear()
        self.engine.slot_req = [None] * self.engine.max_slots

    def _dispatch(self):
        pending_blk = None
        while not self._stop:
            try:
                burst = []
                while len(burst) < self.engine.free_slots():
                    try:
                        burst.append(self.pending.get_nowait())
                    except queue.Empty:
                        break
                if burst:
                    self._admit(burst)
                if getattr(self.engine, "_admissions", None):
                    # chunked prefills: record any outstanding block
                    # FIRST (its tokens predate the mixed steps — mixed
                    # _record appends would otherwise land out of
                    # dispatch order for slots active in both), then
                    # drain every queued chunk with one combined read
                    # (ContinuousEngine.drain_admissions)
                    if pending_blk is not None:
                        self.engine.record_block(pending_blk)
                        pending_blk = None
                    self.engine.drain_admissions()
                    self._resolve_finished()
                    continue
                if any(r is not None for r in self.engine.slot_req):
                    if self.block_steps > 1:
                        # budget-aware block sizing, as the JAX helper;
                        # when every occupied slot's budget is already
                        # dispatched (n == 0), record the pending block
                        # instead of dispatching dead steps
                        n = self.engine.suggested_block(self.block_steps)
                        if n == 0 and pending_blk is not None:
                            self.engine.record_block(pending_blk)
                            pending_blk = None
                        else:
                            blk = self.engine.step_block(n)
                            if pending_blk is not None:
                                self.engine.record_block(pending_blk)
                            pending_blk = blk
                    else:
                        self.engine.step()
                    self._resolve_finished()
                    continue
                if pending_blk is not None:     # drain the last block
                    self.engine.record_block(pending_blk)
                    pending_blk = None
                    self._resolve_finished()
                    continue
                self._resolve_finished()    # submit-time completions
                try:
                    self._admit([self.pending.get(timeout=self.poll_s)])
                except queue.Empty:
                    pass
            except Exception as ex:  # noqa: BLE001 — never kill the thread
                pending_blk = None
                self._fail_all(ex)

    # speculative side path --------------------------------------------------

    def _run_speculative(self, fut: Future, inputs: List, kwargs: dict):
        try:
            from emu_tpu_torch.generation.speculative import \
                speculative_generate
            _, _, ids = self.pipeline.embed_inputs(
                inputs, kwargs.get("is_grounding", False))
            tok = self.pipeline.tokenizer
            d_params, d_cfg = self.draft
            toks = speculative_generate(
                self.pipeline.params["decoder"], self.pipeline.cfg.llama,
                d_params, d_cfg, ids[0],
                max_new=int(kwargs.get("max_new_tokens", 10)),
                k=self.spec_k, eos=tok.eos_token_id)
            fut.set_result(tok.decode(toks, skip_special_tokens=True))
        except Exception as ex:  # noqa: BLE001
            fut.set_exception(ex)


class _Proxy:
    """What get() hands to the route handler: call-shaped like a chat
    pipeline, blocks until the engine (or the speculative side path)
    finishes this request."""

    def __init__(self, helper: ContinuousChatHelper):
        self.helper = helper

    def __call__(self, inputs: List, **kwargs) -> str:
        fut: Future = Future()
        spec = bool(kwargs.pop("speculative", False))
        if spec and self.helper.draft is not None and _text_only(inputs):
            threading.Thread(target=self.helper._run_speculative,
                             args=(fut, inputs, kwargs),
                             daemon=True).start()
        else:
            self.helper.pending.put((fut, inputs, kwargs,
                                     RECORDER.open("request")))
        return fut.result(timeout=600)
