"""Batched KV-cache serving engine (slot-based continuous batching).

The port of ``repro/runtime/serving.py``, its behaviour unchanged but
for the recurrent families' prefill (below): fixed ``slots`` request
slots; prefill runs per request at bucketed prompt lengths; decode runs
one step over all slots per tick, requests at different positions
together; greedy or temperature sampling;
admission pops the waiting list in (priority, deadline, FIFO) order and a
request past its deadline while still waiting is failed fast
(``status="deadline"``) instead of occupying a slot.

Where the JAX engine stacks B = 1 caches on a slot axis and vmaps
``decode_step`` over it, the port keeps one cache with the slots as its
batch and one index per row: a decode tick is one batched forward, each
row at its own position.  Prefill writes a request's keys and values
into its slot's rows in place.  A decode tick also writes into the rows
of free slots; those rows are zeroed and refilled when a request is
admitted, and only live slots advance their index, so nothing of it is
ever read.  Under the JAX engine's vmap each slot's MoE dispatch sees its
one token (capacity 1, nothing dropped); the port's batched decode routes
each row on its own likewise (``models.forward`` in decode mode), so the
slots never compete for an expert's capacity.

Where the cache holds recurrent state (the ssm and hybrid families:
Mamba2's conv window and SSM state), a request is prefilled at its
prompt's true length, not at its bucket: the JAX engine's right padding
would run the pad tokens through the recurrence, so that decode would
start from a state the prompt never reached (ROADMAP.md Queue 3).  The
attention families keep the bucket, whose padded keys decode overwrites.
The audio family (Whisper) is refused: its prefill needs the encoder's
``enc_inputs``, which no request carries (the JAX engine cannot serve it
either); it runs through ``models.prefill(enc_inputs=)`` and
``decode_step``.

Greedy decoding is exact.  Temperature sampling draws from a
``torch.Generator`` seeded from ``seed``: the same distribution as
``jax.random.categorical``, not its bits.

The engine runs on the card unless ``device="cpu"`` is given; the
parameters must lie on that device.
"""
from __future__ import annotations

import itertools
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels.ops import resolve_device
from ..models import forward, init_cache


@dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    generated: List[int] = field(default_factory=list)
    done: bool = False
    status: str = "pending"           # -> "ok" | "deadline"
    tenant: str = "default"
    priority: int = 0
    deadline_s: Optional[float] = None
    t_submit: float = 0.0
    t_deadline: Optional[float] = None
    t_first: Optional[float] = None   # host clock at the first token


#: the families whose cache holds recurrent state, prefilled unpadded
RECURRENT_FAMILIES = ("ssm", "hybrid")


def _bucket(n: int) -> int:
    return 1 << max(4, math.ceil(math.log2(max(n, 1))))


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_seq: int = 256, temperature: float = 0.0, seed: int = 0,
                 device=None):
        if cfg.family == "audio":
            raise ValueError(
                f"the serving engine takes no encoder inputs, so it cannot "
                f"serve {cfg.name} (family audio): run prefill(enc_inputs=) "
                f"and decode_step")
        on = params["embed"].device
        if on.type != resolve_device(device).type:
            raise ValueError(f"the parameters lie on {on}, the engine runs "
                             f"on {resolve_device(device)}")
        self.device = on
        self.cfg, self.params = cfg, params
        self.slots, self.max_seq = slots, max_seq
        self.temperature = temperature
        self.generator = torch.Generator(device=on).manual_seed(seed)
        # prefill at the prompt's true length where the cache is recurrent
        self.true_length = cfg.family in RECURRENT_FAMILIES
        self._uid = itertools.count()
        # one cache, the slots as its batch, one index per slot
        self.cache = init_cache(cfg, slots, max_seq, device=on)
        self.cache["index"] = torch.zeros((slots,), dtype=torch.int64,
                                          device=on)
        self.active: Dict[int, Optional[Request]] = {i: None
                                                     for i in range(slots)}
        self.waiting: List[Request] = []
        self.finished: List[Request] = []
        self._done_now: List[Request] = []
        # host-clock seconds and tokens of prefill (sampling the first
        # token included) and of decode ticks, each ending in a sync
        self.stats = {"prefill_s": 0.0, "prefill_tokens": 0,
                      "decode_s": 0.0, "decode_tokens": 0, "ticks": 0}

    # -- request intake ----------------------------------------------------
    def add_request(self, prompt: List[int], *, max_new_tokens: int = 16,
                    eos_id: Optional[int] = None,
                    deadline_s: Optional[float] = None,
                    tenant: str = "default", priority: int = 0) -> int:
        now = time.perf_counter()
        r = Request(next(self._uid), list(prompt), max_new_tokens, eos_id,
                    tenant=str(tenant), priority=int(priority),
                    deadline_s=deadline_s, t_submit=now,
                    t_deadline=None if deadline_s is None
                    else now + deadline_s)
        self.waiting.append(r)
        return r.uid

    def _sample(self, logits) -> np.ndarray:
        if self.temperature > 0:
            probs = torch.softmax(logits.float() / self.temperature, -1)
            draw = torch.multinomial(probs, 1, generator=self.generator)
            return draw[:, 0].cpu().numpy()
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def _expire_waiting(self):
        """Fail waiting requests that are already past their deadline —
        they must not consume a prefill or a slot."""
        now = time.perf_counter()
        keep = []
        for r in self.waiting:
            if r.t_deadline is not None and now > r.t_deadline:
                r.done = True
                r.status = "deadline"
                self.finished.append(r)
                self._done_now.append(r)
            else:
                keep.append(r)
        self.waiting = keep

    def _slot_cache(self, slot: int):
        """A B = 1 view of ``slot``'s rows of every entry of the cache
        (the layer stacks' (L, B, max_seq, ...) tensors)."""
        view = {key: {k: v[:, slot:slot + 1] for k, v in entry.items()}
                for key, entry in self.cache.items() if key != "index"}
        view["index"] = self.cache["index"][slot]
        return view

    def _admit(self):
        self._expire_waiting()
        # priority first, earliest deadline next, FIFO last — a stable
        # sort of (priority, deadline) leaves deadline-less same-priority
        # traffic in exactly the old FIFO order
        if any(r.priority or r.t_deadline is not None
               for r in self.waiting):
            self.waiting.sort(key=lambda r: (
                -r.priority,
                r.t_deadline if r.t_deadline is not None else math.inf,
                r.uid))
        for slot, occ in self.active.items():
            if occ is not None or not self.waiting:
                continue
            r = self.waiting.pop(0)
            t0 = time.perf_counter()
            plen = len(r.prompt) if self.true_length \
                else _bucket(len(r.prompt))
            toks = np.full((1, plen), 0, np.int64)
            toks[0, :len(r.prompt)] = r.prompt
            cache1 = self._slot_cache(slot)
            for key, entry in cache1.items():
                if key != "index":
                    for x in entry.values():
                        x.zero_()
            logits, _ = forward(self.cfg, self.params,
                                torch.from_numpy(toks).to(self.device),
                                cache=cache1, mode="prefill")
            # bucket-padded on the RIGHT (the attention families): the true
            # last position is len(prompt)-1; rewind index to the true
            # length so decode writes the next token at position
            # len(prompt).
            self.cache["index"][slot] = len(r.prompt)
            # first generated token comes from the prefill logits
            first = int(self._sample(logits[0, len(r.prompt) - 1][None])[0])
            r.t_first = time.perf_counter()
            r.generated = [first]
            self.active[slot] = r
            self.stats["prefill_s"] += r.t_first - t0
            self.stats["prefill_tokens"] += len(r.prompt)

    # -- decode tick ---------------------------------------------------------
    def step(self) -> List[Request]:
        """One engine tick: admit waiting requests, decode all active slots,
        collect finished requests. Returns newly finished."""
        self._admit()
        self._collect()          # requests satisfied by prefill alone
        live = [s for s, r in self.active.items() if r is not None]
        if not live:
            return self._drain_done()
        t0 = time.perf_counter()
        # feed the latest generated token per slot at its cache position
        toks = np.zeros((self.slots, 1), np.int64)
        for s, r in self.active.items():
            if r is not None:
                toks[s, 0] = r.generated[-1]
        logits, new_cache = forward(self.cfg, self.params,
                                    torch.from_numpy(toks).to(self.device),
                                    cache=self.cache, mode="decode")
        nxt = self._sample(logits[:, 0])
        # only live slots advance their index
        live_mask = torch.zeros((self.slots,), dtype=torch.bool,
                                device=self.device)
        live_mask[live] = True
        self.cache["index"] = torch.where(live_mask, new_cache["index"],
                                          self.cache["index"])

        for s in live:
            self.active[s].generated.append(int(nxt[s]))
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_tokens"] += len(live)
        self.stats["ticks"] += 1
        self._collect()
        return self._drain_done()

    def _collect(self):
        for s, r in self.active.items():
            if r is None:
                continue
            if (len(r.generated) >= r.max_new_tokens
                    or (r.eos_id is not None and r.generated
                        and r.generated[-1] == r.eos_id)):
                r.done = True
                r.status = "ok"
                self.finished.append(r)
                self._done_now.append(r)
                self.active[s] = None

    def _drain_done(self) -> List[Request]:
        out, self._done_now = self._done_now, []
        return out

    def run_to_completion(self, max_ticks: int = 1000) -> List[Request]:
        for _ in range(max_ticks):
            self.step()
            if not self.waiting and all(v is None
                                        for v in self.active.values()):
                break
        return self.finished
