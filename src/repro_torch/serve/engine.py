"""Batched decode engine with fixed-slot waves (counterpart of
``repro.serve.engine``).

A fixed number of slots share one KV cache; prompts flow through a
``RequestQueue`` and are packed per wave with ``left_pad_pack``, one
uniform-length prefill per wave (the pad tokens are attended like prompt
tokens, as in the JAX engine), then one decode step per new token. Greedy
(argmax, ties to the lower token id) or temperature sampling from the
engine's own ``torch.Generator`` on the model's device, seeded by
``ServeConfig.seed``. Everything runs on the model's device; the host reads
each step's tokens (to stop at ``eos_id``)."""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from .batching import RequestQueue, left_pad_pack


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 256
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: int = -1              # -1: never stop early
    seed: int = 0


class DecodeEngine:
    def __init__(self, model, params, batch_slots: int, cfg: ServeConfig):
        self.model = model
        self.params = params
        self.slots = batch_slots
        self.cfg = cfg
        self.device = model.device
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)

    def _step(self, cache, tokens: torch.Tensor, cache_len: int):
        return self.model.decode_step(self.params, cache, tokens, cache_len)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """(B,) next tokens (int64, on the device) of (B, V) logits."""
        z = logits.float()
        if self.cfg.temperature <= 0:
            return torch.argmax(z, dim=-1)
        p = torch.softmax(z / self.cfg.temperature, dim=-1)
        return torch.multinomial(p, 1, generator=self._gen)[:, 0]

    def generate(self, prompts: List[List[int]]) -> List[List[int]]:
        """Serve all prompts in waves of ``slots``; returns the generated
        token lists (prompt excluded)."""
        cfg = self.cfg
        queue = RequestQueue()
        futs = [queue.put(p, n=len(p))[0] for p in prompts]
        with torch.inference_mode():
            while len(queue):
                wave = queue.take(self.slots)
                toks, plen = left_pad_pack([e.payload for e in wave],
                                           self.slots)
                results = [[] for _ in wave]
                cache = self.model.init_cache(self.slots, cfg.max_len)
                logits, cache = self._step(
                    cache, torch.as_tensor(toks, device=self.device), 0)
                cache_len = plen
                nxt = self._sample(logits)
                done = [False] * len(wave)
                for _ in range(cfg.max_new_tokens):
                    host = nxt.tolist()
                    for i in range(len(wave)):
                        if not done[i]:
                            results[i].append(host[i])
                            if host[i] == cfg.eos_id:
                                done[i] = True
                    if all(done) or cache_len + 1 >= cfg.max_len:
                        break
                    logits, cache = self._step(
                        cache, nxt[:, None].to(torch.int32), cache_len)
                    cache_len += 1
                    nxt = self._sample(logits)
                for e, out in zip(wave, results):
                    e.future.set_result(out)
        return [f.result() for f in futs]
