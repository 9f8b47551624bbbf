"""Deterministic synthetic token stream for LM training (counterpart of
``repro.data.tokens``).

Checkpointable: the full iterator state is (seed, step). Batches are a
function of (seed, step) only, drawn with numpy exactly as the JAX package
draws them (the same seed and step give the same tokens), then handed over
as int32 tensors on ``device``.

The stream has learnable structure (a random order-1 Markov chain over the
vocab) so small-model training loss decreases visibly below log(V)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass
class TokenStream:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    step: int = 0
    markov_states: int = 64
    device: str = "cuda"

    def __post_init__(self):
        self._device = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        # sparse-ish transition structure mapped into the vocab
        self._trans = rng.integers(0, self.vocab,
                                   size=(self.markov_states, 4),
                                   dtype=np.int64)

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def restore(self, state: dict):
        self.seed = state["seed"]
        self.step = state["step"]

    def next_numpy(self) -> dict:
        """The next batch as int32 numpy arrays (tokens, labels)."""
        rng = np.random.default_rng((self.seed << 20) ^ self.step)
        b, s = self.batch, self.seq
        starts = rng.integers(0, self.markov_states, size=(b,))
        choices = rng.integers(0, 4, size=(b, s))
        toks = np.zeros((b, s), np.int64)
        state = starts
        for t in range(s):
            toks[:, t] = self._trans[state, choices[:, t]]
            state = toks[:, t] % self.markov_states
        self.step += 1
        toks = toks.astype(np.int32)
        return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}

    def next_batch(self) -> dict:
        return {k: torch.as_tensor(v, device=self._device)
                for k, v in self.next_numpy().items()}
