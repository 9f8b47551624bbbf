"""The LM cells' token batches: a frozen copy of the port's synthetic
stream (``repro_torch.data.TokenStream``), so that the benchmark makes its
inputs itself and hands the same batches to the program and to the
reference. Batch ``step`` of a stream is a function of (seed, step) alone:
each row walks an order-1 Markov chain over ``markov_states`` states whose
transitions land on tokens drawn once from the seed, so the tokens have
learnable structure. Drawn with numpy on the host, as the original."""

from __future__ import annotations

import numpy as np
import torch


class Stream:
    """Batches (tokens, labels) of ``batch`` x ``seq`` int32 tokens below
    ``vocab``; labels are the tokens shifted one to the left (the last
    wraps to the first)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int,
                 markov_states: int = 64):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed = int(seed)
        self.markov_states = markov_states
        rng = np.random.default_rng(self.seed)
        self.trans = rng.integers(0, vocab, size=(markov_states, 4),
                                  dtype=np.int64)

    def numpy(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ int(step))
        b, s = self.batch, self.seq
        state = rng.integers(0, self.markov_states, size=(b,))
        choices = rng.integers(0, 4, size=(b, s))
        toks = np.zeros((b, s), np.int64)
        for t in range(s):
            toks[:, t] = self.trans[state, choices[:, t]]
            state = toks[:, t] % self.markov_states
        toks = toks.astype(np.int32)
        return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}

    def batch_at(self, step: int, device) -> dict:
        return {k: torch.as_tensor(v, device=device)
                for k, v in self.numpy(step).items()}


__all__ = ["Stream"]
