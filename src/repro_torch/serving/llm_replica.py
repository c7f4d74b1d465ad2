"""The serving replica's model: greedy generation with the serve step.

``SharedModel`` is the reference's (``repro.serving.llm_replica``): one
model and its decode step, shared by the replicas of a demo.  The
replica itself (``LLMReplica``) needs the broker, replica and controller
port and waits for it.

``generate`` reproduces the reference's behaviour, quirks included: the
batch is padded to ``max_batch``; shorter prompts are right-padded with
token 0 and those zeros are teacher-forced like real tokens; the prompts
run through the decode path one token at a time; prompts and generated
tokens share one ``cache_len``; greedy ``argmax`` takes the first
maximum.  An RWKV model carries its constant-size state instead of a KV
cache (``max_len`` is then unused).  Every step stays on the card; the
tokens come to the host once, at the end.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import ArchConfig, init_decode_state, init_params


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
