"""Continuous batching: decode-step-level request scheduling, as
`emu_tpu/generation/continuous.py`.

A fixed pool of batch slots advances ONE decode step per token across
whatever mix of requests occupies the slots; new requests prefill into free
slots between steps (batched per prompt-length bucket) and finished ones
leave at once, so short requests never wait for long ones. Prompts longer
than the largest bucket stream in `chunk_size` tokens per MIXED step while
every other slot keeps decoding (chunked prefill).

All per-slot state (KV cache, write indices, rope positions, last tokens,
active flags, budgets, temperatures) lives on the device in fixed-shape
tensors, as in the JAX engine; admission and retirement are indexed writes
into them. Where the JAX engine donates its state to jitted programs, this
one updates it in place. Device work is queued asynchronously: `step_block`
returns before its tokens exist, and the host reads them in `record_block`
(one transfer per block), so a caller may dispatch the next block first.

Sampling draws Gumbel noise from a `torch.Generator` seeded from `seed`
(the JAX engine's `jax.random` stream cannot be reproduced); rows at
temperature 0 take the argmax and stay exactly greedy.

A tree sharded over "model" (`parallel.shard_params`) serves from a mesh
slice: each rank's pool caches its kv heads, and every rank of the group
runs the same admissions and steps (one process a rank, the same requests
submitted to each) and records the same tokens.

Every decode, mixed and prefill step is a record of `profiling.RECORDER`
("engine.decode", "engine.mixed", "engine.prefill": a host span and a CUDA
event pair) with the rows it computed ("rows": max_slots, max_slots +
chunk_size, the bucket x the prefill's rows) and, once its results are
read, the rows that carried a token ("useful": active decode rows plus
the chunk's or the prompts' real tokens). A request's record ("request",
the serving helper's, else the engine's own) gets its "first" and "last"
token marks: the steps that made them, whose device ends time them.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from emu_tpu_torch.models import llama
from emu_tpu_torch.utils.profiling import RECORDER, Record


@dataclass
class _Request:
    req_id: int
    prompt_len: int
    max_new: int
    tokens: List = field(default_factory=list)   # ints, or device scalars
    done: bool = False
    record: Optional[Record] = None     # the recorder's "request"


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket "
                     f"{buckets[-1]}")


class ContinuousEngine:
    """Slot-pool greedy/sampling decode engine over the LLaMA decoder.

    submit() admits a request into a free slot (prefill); step() advances
    every active slot one token; finished() drains completed requests.
    """

    def __init__(self, params, cfg, *, max_slots: int = 8,
                 max_len: int = 512, prefill_buckets=(32, 64, 128, 256),
                 eos_token_id: Optional[int] = 2, temperature: float = 0.0,
                 cache_dtype=None, kv_cache_quant: bool = False,
                 chunk_size: Optional[int] = None, seed: int = 0,
                 per_request_sampling: bool = False,
                 max_prefill_rows: Optional[int] = None):
        self.params, self.cfg = params, cfg
        max_len = -(-max_len // 8) * 8
        self.max_slots, self.max_len = max_slots, max_len
        self.buckets = tuple(sorted(b for b in prefill_buckets
                                    if b <= max_len))
        self.eos = -1 if eos_token_id is None else int(eos_token_id)
        self.temperature = float(temperature)
        # per_request_sampling: submit(..., temperature=t) overrides the
        # pool default per slot; pure-greedy pools skip the noise draw
        self.sampling = per_request_sampling or self.temperature > 0
        self.per_request_sampling = per_request_sampling
        # chunked admission; <= 32 keeps mixed steps on kernel D
        self.chunk_size = chunk_size
        # caps the rows of one batched prefill (its transient cache)
        self.max_prefill_rows = max_prefill_rows
        self._admissions: List[dict] = []
        self.device = params["norm"].device
        RECORDER.anchor(self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._ids = itertools.count()
        self.requests: Dict[int, _Request] = {}
        self.slot_req: List[Optional[int]] = [None] * max_slots
        # per-slot admission generation: record_block applies a block's
        # rows only to the request that held the slot when it was
        # dispatched (a slot retired and readmitted in between is skipped)
        self._slot_gen: List[int] = [0] * max_slots
        # per-slot tokens DISPATCHED since admission (suggested_block)
        self._dispatched: List[int] = [0] * max_slots
        if cache_dtype is None:
            cache_dtype = params["norm"].dtype
        dev, n = self.device, max_slots
        self._bidx = torch.arange(n, device=dev)
        self._arange_len = torch.arange(max_len, device=dev)
        self.state = {
            "cache": llama.init_cache(cfg, n, max_len, device=dev,
                                      dtype=cache_dtype,
                                      quant=kv_cache_quant, params=params),
            "slot_mask": torch.zeros(n, max_len, dtype=torch.bool,
                                     device=dev),
            "write_idx": torch.zeros(n, dtype=torch.long, device=dev),
            "position": torch.zeros(n, dtype=torch.long, device=dev),
            "last_token": torch.zeros(n, dtype=torch.long, device=dev),
            "active": torch.zeros(n, dtype=torch.bool, device=dev),
            "n_generated": torch.zeros(n, dtype=torch.long, device=dev),
            "max_new": torch.zeros(n, dtype=torch.long, device=dev),
            "temperature": torch.full((n,), self.temperature, device=dev),
        }

    # -- device programs ---------------------------------------------------

    def _sample(self, logits, temps):
        """Per-row next token: sampled where temps > 0, greedy otherwise."""
        greedy = logits.argmax(-1)
        if not self.sampling:
            return greedy
        u = torch.rand(logits.shape, generator=self._gen,
                       device=logits.device).clamp_min(1e-20)
        t = temps.clamp_min(1e-6)[:, None]
        sampled = (logits.float() / t - torch.log(-torch.log(u))).argmax(-1)
        return torch.where(temps > 0, sampled, greedy)

    def _step_body(self):
        """One decode step of every slot; returns (tokens [B] (0 where the
        row was inactive), the active flags before the step)."""
        params, st = self.params, self.state
        active = st["active"]
        slots = st["write_idx"]
        bidx = self._bidx
        # the new token's own slot becomes attendable (active rows only)
        st["slot_mask"][bidx, slots] = st["slot_mask"][bidx, slots] | active
        embeds = llama.embed(params, st["last_token"][:, None])
        hidden, _ = llama.decode_step_rows(params, self.cfg, st["cache"],
                                           embeds, slots, st["slot_mask"],
                                           st["position"])
        nxt = self._sample(llama.logits(params, hidden[:, 0]),
                           st["temperature"])
        n_gen = st["n_generated"] + active
        out_tok = torch.where(active, nxt, 0)
        still = active & (nxt != self.eos) & (n_gen < st["max_new"])
        st.update(write_idx=slots + active, position=st["position"] + active,
                  last_token=torch.where(active, nxt, st["last_token"]),
                  active=still, n_generated=n_gen)
        return out_tok, active

    def _mixed(self, chunk_emb, admit_slot: int, qlen: int, final: bool,
               max_new_admit: int, temp_admit: float):
        """One MIXED step (chunked prefill): every active slot decodes its
        next token (one row each) while `admit_slot` consumes `qlen` prompt
        tokens of `chunk_emb` [q, D] (q more rows: `llama.
        decode_packed_rows`); when `final`, the admitting row samples its
        first generated token from its last chunk row. Inactive,
        non-admitting rows ride along masked."""
        params, st = self.params, self.state
        active = st["active"]
        bidx = self._bidx
        is_admit = bidx == admit_slot

        base = llama.embed(params, st["last_token"])              # [B, D]
        tok = torch.cat([base, chunk_emb.to(base.dtype)])        # [B + q, D]
        slots = st["write_idx"]
        hid, _ = llama.decode_packed_rows(params, self.cfg, st["cache"], tok,
                                          admit_slot, slots, st["slot_mask"],
                                          st["position"])
        row = torch.where(is_admit, self.max_slots + qlen - 1, bidx)
        temps = torch.where(is_admit, temp_admit, st["temperature"])
        nxt = self._sample(llama.logits(params, hid[row]), temps)

        # decode-row bookkeeping (as _step_body)
        n_gen = st["n_generated"] + active
        out_tok = torch.where(active, nxt, 0)
        still = active & (nxt != self.eos) & (n_gen < st["max_new"])
        sm = st["slot_mask"]
        sm[bidx, slots] = sm[bidx, slots] | active
        # the admitting row: validate its qlen chunk slots
        admit_start = slots[admit_slot]
        ar = self._arange_len[None]
        sm |= is_admit[:, None] & (ar >= admit_start) & (ar < admit_start
                                                         + qlen)
        first = nxt[admit_slot]
        admit_alive = (first != self.eos) & final & (max_new_admit > 1)
        last_token = torch.where(active, nxt, st["last_token"])
        st.update(
            write_idx=torch.where(is_admit, admit_start + qlen,
                                  slots + active),
            position=st["position"] + torch.where(is_admit, qlen,
                                                  active.long()),
            last_token=torch.where(is_admit & final, first, last_token),
            active=torch.where(is_admit, admit_alive, still),
            n_generated=torch.where(is_admit, int(final), n_gen),
            max_new=torch.where(is_admit, max_new_admit, st["max_new"]),
            temperature=torch.where(is_admit, temp_admit,
                                    st["temperature"]))
        return out_tok, active, first

    def _prefill(self, embeds, mask, s_bucket: int, slots, max_new, temps,
                 valid):
        """BATCHED prefill admission: embeds [p, s_bucket, D] into `slots`
        [p] in one prefill. Pad rows (valid False) duplicate row 0 and
        take row 0's first token, so every duplicate write carries the same
        values."""
        params, st = self.params, self.state
        p = embeds.shape[0]
        big = st["cache"]
        small = llama.init_cache(self.cfg, p, s_bucket, device=self.device,
                                 dtype=big["k"].dtype,
                                 quant="k_scale" in big, params=params)
        hidden, small = llama.prefill(params, self.cfg, embeds, mask, small)
        first = self._sample(llama.logits(params, hidden[:, -1]), temps)
        first = torch.where(valid, first, first[0])
        for n, plane in big.items():       # value and scale planes alike
            plane[:, slots, :, :s_bucket] = small[n]
        row_mask = torch.zeros(p, self.max_len, dtype=torch.bool,
                               device=self.device)
        row_mask[:, :s_bucket] = mask.bool()
        st["slot_mask"][slots] = row_mask
        st["write_idx"][slots] = s_bucket
        st["position"][slots] = mask.long().sum(1)
        st["last_token"][slots] = first
        st["active"][slots] = (first != self.eos) & (max_new > 1)
        st["n_generated"][slots] = 1
        st["max_new"][slots] = max_new
        st["temperature"][slots] = temps
        return first

    # -- public API --------------------------------------------------------

    def close(self):
        """Release the device state (the KV cache) now."""
        self.state = None
        self._gen = None

    def free_slots(self) -> int:
        return sum(r is None for r in self.slot_req)

    def _effective_temp(self, temperature) -> float:
        if temperature is None:
            return self.temperature
        t = float(temperature)
        if t > 0 and not self.sampling:
            raise ValueError(
                "engine built greedy-only; construct with "
                "per_request_sampling=True (or a pool temperature > 0) "
                "to accept sampled requests")
        return t

    def check_request(self, inputs_embeds, attention_mask, max_new: int,
                      temperature: Optional[float] = None) -> float:
        """Raise ValueError if this request cannot be admitted: its prompt
        bucket (with chunk_size set and a prompt beyond the buckets: its
        valid tokens) plus max_new past max_len, or a sampled request on a
        greedy-only engine. Admits nothing; returns the request's
        temperature."""
        temp = self._effective_temp(temperature)
        s = inputs_embeds.shape[1]
        if self.chunk_size and s > self.buckets[-1]:
            if int(attention_mask[0].bool().sum()) + max_new > self.max_len:
                raise ValueError("prompt + max_new exceeds max_len")
        elif _bucket(s, self.buckets) + max_new > self.max_len:
            raise ValueError("prompt bucket + max_new exceeds max_len")
        return temp

    @torch.no_grad()
    def submit(self, inputs_embeds, attention_mask, max_new: int,
               temperature: Optional[float] = None) -> int:
        """Admit one request (embeds [1, S, D], mask [1, S]); returns its
        id. Prompts within the buckets prefill now and take their first
        token; with chunk_size set, longer prompts park as a CHUNKED
        admission that step() streams in. `temperature` overrides the pool
        default for this request (needs per_request_sampling=True)."""
        slot = self.slot_req.index(None)   # raises ValueError when full
        temp = self.check_request(inputs_embeds, attention_mask, max_new,
                                  temperature)
        s = inputs_embeds.shape[1]
        if self.chunk_size and s > self.buckets[-1]:
            return self._submit_chunked(slot, inputs_embeds, attention_mask,
                                        max_new, temp)
        first, req = self._prefill_rows(
            [(inputs_embeds, attention_mask, max_new, temp)], [slot])
        req, first = req[0], int(first[0])
        req.tokens.append(first)
        if first == self.eos or max_new <= 1:
            req.done = True
        else:
            self.slot_req[slot] = req.req_id
        return req.req_id

    @torch.no_grad()
    def submit_many(self, reqs, temps: Optional[List[float]] = None,
                    records: Optional[List[Optional[Record]]] = None
                    ) -> List[int]:
        """Admit several requests at once: (embeds, mask, max_new[,
        temperature]) tuples, at most free_slots() of them. One batched
        prefill runs per prompt bucket (at most max_prefill_rows rows
        each) and the first tokens stay on the device until recorded.
        Prompts beyond the buckets (chunk_size set) take the chunked
        path. Every request is checked (`check_request`) before any is
        admitted, so a burst that raises leaves no slot taken; a caller
        that has checked each row already (the serving helper, which
        fails only the bad request) passes the temperatures
        `check_request` returned as `temps`, and its requests' recorder
        records (`profiling.Record`, queued when they arrived) as
        `records`."""
        if len(reqs) > self.free_slots():
            raise ValueError(f"{len(reqs)} requests > {self.free_slots()} "
                             "free slots")
        if temps is None:
            temps = [self.check_request(*r[:3], r[3] if len(r) > 3 else None)
                     for r in reqs]
        if records is None:
            records = [None] * len(reqs)
        ids: List[Optional[int]] = [None] * len(reqs)
        groups: Dict[int, List] = {}
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        for j, (r, temp) in enumerate(zip(reqs, temps)):
            embeds, mask, max_new = r[:3]
            s = embeds.shape[1]
            if self.chunk_size and s > self.buckets[-1]:
                ids[j] = self._submit_chunked(
                    free.pop(0), embeds, mask, max_new, temp, records[j])
                continue
            groups.setdefault(_bucket(s, self.buckets), []).append(
                (j, (embeds, mask, max_new, temp)))
        cap = self.max_prefill_rows or len(reqs) or 1
        for group in groups.values():
            for at in range(0, len(group), cap):
                sub = group[at:at + cap]
                slots = [free.pop(0) for _ in sub]
                firsts, group_reqs = self._prefill_rows(
                    [row for _, row in sub], slots,
                    [records[j] for j, _ in sub])
                for i, (req, slot) in enumerate(zip(group_reqs, slots)):
                    req.tokens.append(firsts[i])   # device scalar: deferred
                    self.slot_req[slot] = req.req_id
                    ids[sub[i][0]] = req.req_id
        return ids

    def _new_request(self, prompt_len: int, max_new: int,
                     record: Optional[Record]) -> _Request:
        """Register a request; `record` is its recorder record (the serving
        helper's, queued earlier), else one opened now, queued and admitted
        at once."""
        if record is None:
            record = RECORDER.open("request")
            if record is not None:
                record.marks["admitted"] = record.start
        req = _Request(next(self._ids), prompt_len, max_new, record=record)
        self.requests[req.req_id] = req
        return req

    def _prefill_rows(self, group, slots, records=None):
        """Pad the group to a power-of-two row count by duplicating row 0,
        run one batched prefill; returns (first tokens [p], requests).
        Bumps each slot's generation. `records`: the requests' recorder
        records, where the caller has them."""
        s_b = _bucket(max(e.shape[1] for e, *_ in group), self.buckets)
        n = len(group)
        p = 1 << (n - 1).bit_length()
        rows, masks, max_news, temps = [], [], [], []
        for embeds, mask, max_new, temp in group:
            pad = s_b - embeds.shape[1]
            rows.append(F.pad(embeds, (0, 0, pad, 0))[0])
            masks.append(F.pad(mask, (pad, 0))[0])
            max_news.append(max_new)
            temps.append(temp)
        for _ in range(p - n):                   # duplicate row 0
            rows.append(rows[0])
            masks.append(masks[0])
            max_news.append(max_news[0])
            temps.append(temps[0])
        group_reqs = [self._new_request(embeds.shape[1], max_new, rec)
                      for (embeds, _, max_new, _), rec in zip(
                          group, records or [None] * n)]
        dev = self.device
        with RECORDER.span("engine.prefill", dev) as step:
            firsts = self._prefill(
                torch.stack(rows).to(dev), torch.stack(masks).to(dev), s_b,
                torch.tensor(list(slots) + [slots[0]] * (p - n), device=dev),
                torch.tensor(max_news, device=dev),
                torch.tensor(temps, dtype=torch.float32, device=dev),
                torch.tensor([i < n for i in range(p)], device=dev))
        _step_rows(step, s_b * p, sum(r.prompt_len for r in group_reqs))
        _useful(step, 0)
        for req, slot in zip(group_reqs, slots):
            self._slot_gen[slot] += 1
            self._dispatched[slot] = 1          # the prefill's first token
            _first_token(req, step)
        return firsts, group_reqs

    def retirements_pending(self) -> bool:
        """True when some occupied slot has already been DISPATCHED its
        whole budget (its retirement sits in an unrecorded block)."""
        return any(rid is not None
                   and self._dispatched[slot]
                   >= self.requests[rid].max_new
                   for slot, rid in enumerate(self.slot_req))

    def suggested_block(self, max_steps: int, floor: int = 4) -> int:
        """Budget-aware block size: the steps until the earliest possible
        budget retirement among occupied slots, clamped to [floor,
        max_steps]; 0 when every occupied slot is already dispatched its
        whole budget (their retirements sit in blocks not yet recorded:
        any step now would be a dead one; the JAX engine returns `floor`
        here)."""
        rems = [self.requests[rid].max_new - self._dispatched[slot]
                for slot, rid in enumerate(self.slot_req)
                if rid is not None]
        rems = [r for r in rems if r > 0]
        if not rems:
            return 0
        return max(floor, min(max_steps, min(rems)))

    def _submit_chunked(self, slot: int, inputs_embeds, attention_mask,
                        max_new: int, temp: float = 0.0,
                        record: Optional[Record] = None) -> int:
        valid = attention_mask[0].bool().to(inputs_embeds.device)
        emb = inputs_embeds[0][valid]                    # drop padding
        s = emb.shape[0]
        # reset the slot's device state; the admission streams from 0
        st = self.state
        st["slot_mask"][slot] = False
        for key in ("write_idx", "position", "active", "n_generated"):
            st[key][slot] = 0
        req = self._new_request(s, max_new, record)
        self._slot_gen[slot] += 1
        self.slot_req[slot] = req.req_id      # reserve through admission
        self._admissions.append({"req": req, "slot": slot, "embeds": emb,
                                 "offset": 0, "max_new": max_new,
                                 "temp": temp})
        return req.req_id

    def _dispatch_mixed(self):
        """Dispatch the head admission's next chunk; returns (out_tok,
        was_active, first, final, admission, the step's record)."""
        a = self._admissions[0]
        q = self.chunk_size
        chunk = a["embeds"][a["offset"]:a["offset"] + q]
        qlen = chunk.shape[0]
        final = a["offset"] + qlen >= a["embeds"].shape[0]
        if qlen < q:
            chunk = F.pad(chunk, (0, 0, 0, q - qlen))
        with RECORDER.span("engine.mixed", self.device) as step:
            out_tok, was_active, first = self._mixed(
                chunk, a["slot"], qlen, final, a["max_new"], a["temp"])
        _step_rows(step, self.max_slots + q, qlen)
        if final:
            _first_token(a["req"], step)
        for slot, rid in enumerate(self.slot_req):
            if rid is not None and slot != a["slot"]:
                self._dispatched[slot] += 1
        a["offset"] += qlen
        if final:
            self._admissions.pop(0)
            self._dispatched[a["slot"]] = 1
        return out_tok, was_active, first, final, a, step

    def _finish_admission(self, a, first: int) -> None:
        req = a["req"]
        req.tokens.append(first)
        if first == self.eos or a["max_new"] <= 1:
            req.done = True
            self.slot_req[a["slot"]] = None

    def _step_mixed(self) -> int:
        """One mixed step: the head admission consumes a chunk, everyone
        else decodes. Returns #decode slots advanced."""
        out_tok, was_active, first, final, a, step = self._dispatch_mixed()
        advanced = self._record(out_tok, was_active, step)
        if final:
            self._finish_admission(a, int(first))
        return advanced

    def _record(self, out_tok, was_active, step: Optional[Record]) -> int:
        """Append each advanced slot's token; retire finished ones.
        `step` is the step's record."""
        out_tok = out_tok.tolist()
        was_active = was_active.tolist()
        still = self.state["active"].tolist()
        _useful(step, sum(was_active))
        advanced = 0
        for slot, rid in enumerate(self.slot_req):
            if rid is None:
                continue
            req = self.requests[rid]
            if was_active[slot]:
                advanced += 1
                req.tokens.append(out_tok[slot])
                _last_token(req, step)
            elif not req.tokens:
                continue    # chunked admission still streaming its prompt
            # a deferred admission whose first token ended it was never
            # active: `still` is current state here, so retire it now
            if not still[slot]:
                req.done = True
                self.slot_req[slot] = None
        return advanced

    @torch.no_grad()
    def drain_admissions(self) -> int:
        """Dispatch mixed steps for EVERY queued chunked admission
        back-to-back, then replay the bookkeeping after reading the
        results once. Returns the number of mixed steps dispatched."""
        if not self._admissions:
            return 0
        recs = []
        while self._admissions:
            recs.append(self._dispatch_mixed())
        fetched = [(o.tolist(), w.tolist(), int(f))
                   for o, w, f, _, _, _ in recs]
        still = self.state["active"].tolist()
        for (_, _, _, final, a, step), (out_tok, was_active, first) in zip(
                recs, fetched):
            _useful(step, sum(was_active))
            for slot, rid in enumerate(self.slot_req):
                if rid is not None and was_active[slot]:
                    req = self.requests[rid]
                    req.tokens.append(out_tok[slot])
                    _last_token(req, step)
            if final:
                self._finish_admission(a, first)
        for slot, rid in enumerate(self.slot_req):
            if rid is not None and not still[slot] \
                    and self.requests[rid].tokens:
                self.requests[rid].done = True
                self.slot_req[slot] = None
        return len(recs)

    def _decode_step(self):
        """`_step_body` as the recorder's "engine.decode" step: (tokens,
        active flags, its record)."""
        with RECORDER.span("engine.decode", self.device) as step:
            out_tok, was_active = self._step_body()
        _step_rows(step, self.max_slots)
        return out_tok, was_active, step

    @torch.no_grad()
    def step(self) -> int:
        """Advance every active slot one token. Returns #slots advanced."""
        if self._admissions:
            return self._step_mixed()
        for slot, rid in enumerate(self.slot_req):
            if rid is not None:
                self._dispatched[slot] += 1
        return self._record(*self._decode_step())

    @torch.no_grad()
    def step_block(self, n_steps: int):
        """Queue `n_steps` decode steps; returns an opaque block result for
        record_block. Its tensors are not read here, so a caller may
        dispatch the NEXT block before recording this one. Chunked
        admissions must be drained first. n_steps = 0 runs no step: its
        record only reads which slots are still active (a deferred
        admission that ended on its first token)."""
        if self._admissions:
            raise RuntimeError(
                "chunked admissions in flight; drain with step() first")
        rows, steps = [], []
        for _ in range(n_steps):
            out_tok, was_active, step = self._decode_step()
            steps.append(step)
            rows.append(out_tok[None])
            rows.append(was_active[None].long())
        for slot, rid in enumerate(self.slot_req):
            if rid is not None:
                self._dispatched[slot] += n_steps
        # [n_steps tokens; n_steps active flags; active now]
        packed = torch.cat(rows[0::2] + rows[1::2]
                           + [self.state["active"][None].long()])
        return packed, n_steps, tuple(self._slot_gen), steps

    def record_block(self, block) -> int:
        """Read + bookkeep one step_block result: append each advanced
        slot's tokens, retire slots that finished within the block. Only
        slots whose admission generation matches the block's dispatch-time
        snapshot are touched. Returns the (slot, step) advances."""
        return self.record_blocks([block])

    def record_blocks(self, blocks) -> int:
        """Record several queued step_block results, in dispatch order."""
        advanced = 0
        fetched = [b[0].cpu().numpy() for b in blocks]
        for packed, (_, n_steps, gens, steps) in zip(fetched, blocks):
            toks = packed[:n_steps]
            actives = packed[n_steps:2 * n_steps].astype(bool)
            still = packed[2 * n_steps].astype(bool)
            for step, live in zip(steps, actives):
                _useful(step, int(live.sum()))
            for slot, rid in enumerate(self.slot_req):
                if rid is None or gens[slot] != self._slot_gen[slot]:
                    continue
                req = self.requests[rid]
                live = actives[:, slot]
                if live.any():
                    req.tokens.extend(int(t) for t in toks[live, slot])
                    advanced += int(live.sum())
                    _last_token(req, steps[int(live.nonzero()[0][-1])])
                # gen match: `still` speaks for the current request,
                # including a deferred admission that ended on its first
                # token
                if not still[slot]:
                    req.done = True
                    self.slot_req[slot] = None
        return advanced

    def finished(self) -> Dict[int, List[int]]:
        """Drain completed requests: {req_id: generated token ids}.
        Deferred first tokens (submit_many) are read here."""
        out = {}
        for rid in [r for r, q in self.requests.items() if q.done]:
            req = self.requests.pop(rid)
            out[rid] = [int(t) for t in req.tokens]
            RECORDER.close(req.record, tokens=len(out[rid]))
        return out

    def run_until_drained(self, max_steps: int = 10_000):
        for _ in range(max_steps):
            if (self.step() == 0 and not self._admissions
                    and all(r is None for r in self.slot_req)):
                break
        return self.finished()


# -- the recorder's counts, where the results are already on the host ------


def _step_rows(step: Optional[Record], rows: int, prompt: int = 0) -> None:
    """A step's rows computed and the prompt tokens among them (a mixed
    step's chunk, a prefill's prompts)."""
    if step is None:
        return
    step.counts.update(rows=rows, prompt=prompt)
    RECORDER.count("engine.rows", rows)


def _useful(step: Optional[Record], active: int) -> None:
    """A step's rows that carried a token, once its results are read: its
    active decode rows plus its prompt tokens."""
    if step is None:
        return
    n = active + step.counts.get("prompt", 0)
    step.counts["useful"] = n
    RECORDER.count("engine.useful_rows", n)


def _first_token(req: _Request, step: Optional[Record]) -> None:
    if req.record is not None and step is not None:
        req.record.marks["first"] = req.record.marks["last"] = step


def _last_token(req: _Request, step: Optional[Record]) -> None:
    if req.record is not None and step is not None:
        req.record.marks["last"] = step
