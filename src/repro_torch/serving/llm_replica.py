"""The LLM-serving replica: the paper's consumer whose "insert into data
lake" phase is batched greedy generation with the model's serve step --
request streams (partitions) in, generated tokens out (a copy of
``repro.serving.llm_replica``).

``SharedModel`` is one model and its decode step, shared by the replicas
of a demo.  ``generate`` reproduces the reference's behaviour, quirks
included: the batch is padded to ``max_batch``; shorter prompts are
right-padded with token 0 and those zeros are teacher-forced like real
tokens; the prompts run through the decode path one token at a time;
prompts and generated tokens share one ``cache_len``; greedy ``argmax``
takes the first maximum.  An RWKV model carries its constant-size state
instead of a KV cache (``max_len`` is then unused); a hybrid (jamba)
model a KV cache for its attention layers and a Mamba state for the
others; a MoE model routes each decode step's batch as dispatch groups
(``models.moe``).  Every step stays on
the card; the tokens come to the host once, at the end.

``LLMReplica`` reads one request a record, ``{"prompt": [ids], "gen":
n}``, drains up to BATCH_BYTES of them a cycle (phase 1), decodes them in
chunks of ``model.max_batch`` (phase 3: real compute) and handles its
mailbox and acks exactly as the base replica (phase 4), so the
controller, the two-phase migration and failure handling are the same
whether the payload is bytes or tokens.  The reference's quirks stay:
every chunk of a cycle generates the *last* request's ``gen`` tokens,
and the heartbeat carries ``tokens`` in place of ``capacity``.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.broker import Broker
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import ArchConfig, init_decode_state, init_params

from .replica import Replica, ReplicaConfig, Sink


class SharedModel:
    """One model and its serve step.  ``params=None`` draws random weights
    on ``device`` (``None`` = the CUDA card) from ``seed``; a test injects
    the reference's weights through ``convert.params_from_numpy``."""

    def __init__(self, cfg: ArchConfig, max_len: int = 64,
                 max_batch: int = 8, seed: int = 0, device=None,
                 params: Optional[Dict] = None):
        self.cfg = cfg
        self.max_len = max_len
        self.max_batch = max_batch
        self.device = resolve_device(device)
        self.params = (init_params(cfg, seed, self.device) if params is None
                       else params)
        self._step = make_serve_step(cfg, self.device)

    def generate(self, prompts: List[List[int]], gen: int) -> np.ndarray:
        """Greedy-decode ``gen`` tokens for up to ``max_batch`` prompts;
        returns int32 [len(prompts), gen]."""
        bsz = len(prompts)
        if not 0 < bsz <= self.max_batch:
            raise ValueError(f"{bsz} prompts; want 1..{self.max_batch}")
        state = init_decode_state(self.cfg, self.max_batch, self.max_len,
                                  self.device)
        maxp = max(len(p) for p in prompts)
        toks = np.zeros((self.max_batch, maxp), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        toks = torch.as_tensor(toks, device=self.device)
        logits = None
        for t in range(maxp):
            logits, state = self._step(self.params, state,
                                       {"inputs": toks[:, t]})
        cur = torch.argmax(logits, dim=-1).to(torch.int32)
        out = []
        for _ in range(gen):
            out.append(cur)
            logits, state = self._step(self.params, state, {"inputs": cur})
            cur = torch.argmax(logits, dim=-1).to(torch.int32)
        if not out:
            return np.zeros((bsz, 0), np.int32)
        return torch.stack(out, dim=1).cpu().numpy()[:bsz]


class LLMReplica(Replica):
    """A consumer whose cycle decodes its requests with ``model`` (one
    ``SharedModel``, on the device the model was built for)."""

    def __init__(self, cid: int, broker: Broker, sink: Sink,
                 config: Optional[ReplicaConfig], model: SharedModel):
        super().__init__(cid, broker, sink, config)
        self.model = model
        self.generated_tokens = 0
        self.requests_served = 0

    def step(self, dt: float) -> int:
        if not self.alive or self.crashed:
            return 0
        budget = self.cfg.rate * self.rate_factor * dt + self._carry
        fetch_cap = int(min(self.cfg.batch_bytes, budget))
        batches = self.handle.poll(fetch_cap) if fetch_cap > 0 else {}

        consumed = 0
        requests: List[List[int]] = []
        gen_n = 8
        for tp, recs in batches.items():
            for r in recs:
                req = json.loads(r.value) if isinstance(r.value, str) else r.value
                requests.append(list(req.get("prompt", [1])))
                gen_n = int(req.get("gen", 8))
                consumed += r.nbytes
        # phase 3: batched generation (chunks of the model's max batch)
        for i in range(0, len(requests), self.model.max_batch):
            chunk = requests[i:i + self.model.max_batch]
            out = self.model.generate(chunk, gen_n)
            self.generated_tokens += int(out.size)
            self.requests_served += len(chunk)
            self.sink.insert("generations", out.size * 4, len(chunk))
        for tp, recs in batches.items():
            self.handle.commit(tp, recs[-1].offset + 1)

        self._carry = min(budget - consumed, self.cfg.rate * self.rate_factor)
        self.consumed_bytes += consumed
        self.last_rate = consumed / dt if dt > 0 else 0.0
        self.backlog_hint = sum(self.broker.lag(self.cfg.group, tp)
                                for tp in self.handle.assigned)
        for msg in self._read_metadata():
            self._apply_metadata(msg)
        if self.alive:
            self._send({"type": "heartbeat",
                        "stats": {"rate": self.last_rate,
                                  "backlog": self.backlog_hint,
                                  "tokens": self.generated_tokens}})
        return consumed
