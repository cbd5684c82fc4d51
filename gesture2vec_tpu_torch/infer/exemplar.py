"""Exemplar retrieval: token -> a stored DAE-latent window.

The port's copy of the JAX package's `infer/exemplar.py` ExemplarBank.
The reference's shipped text -> gesture path plays, for each predicted
token, a random corpus window of that token's cluster. A token with no
window takes its nearest populated token by codebook distance.

The picks run on the host in numpy and draw from the caller's
np.random.Generator exactly as the JAX package draws (one `random(n)`
batch per `pick_indices`; one `integers(len)` for the first token of a
`pick_indices_continuity` chain), so the same seed gives the same picks.
`make_decode_fn` keeps the bank's latents resident on the device; a
request moves only its pick indices there, gathers the windows and runs
the DAE decode.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


class ExemplarBank:
    """Token -> latent-window lookup over a cluster latent dataset
    ({"tokens": (N,), "dae_latents": (N, T, R)}). rng is the caller's
    generator, shared so that retrieval consumes its stream in order."""

    def __init__(self, latent_bank: Dict[str, np.ndarray], n_tokens: int,
                 codebook: np.ndarray, rng: np.random.Generator):
        toks = latent_bank["tokens"]
        self._index = [np.where(toks == t)[0] for t in range(n_tokens)]
        self._populated = np.array(
            [t for t in range(n_tokens) if len(self._index[t])])
        self._codebook = np.asarray(codebook)
        self._latents = latent_bank["dae_latents"]
        self._rng = rng
        self._resolve_cache: dict = {}
        # first / last latent frame of every window, for continuity picks
        lats = np.asarray(self._latents, np.float32)
        self._first_frames = np.ascontiguousarray(lats[:, 0])
        self._last_frames = np.ascontiguousarray(lats[:, -1])

    def make_decode_fn(self, dae_model: torch.nn.Module,
                       device: torch.device
                       ) -> Callable[[np.ndarray], torch.Tensor]:
        """picks (P,) -> motion frames (P * T, pose_dim) on the device.
        The bank moves to the device once, here; the returned function's
        `bank` attribute is that tensor."""
        bank = torch.from_numpy(np.ascontiguousarray(
            self._latents, dtype=np.float32)).to(device)

        def exemplar_decode(picks: np.ndarray) -> torch.Tensor:
            idx = torch.from_numpy(np.asarray(picks, np.int64)).to(device)
            lats = bank[idx]
            return dae_model.decode(lats.reshape(-1, lats.shape[-1]))

        exemplar_decode.bank = bank
        return exemplar_decode

    def pick_indices(self, tokens) -> np.ndarray:
        """One uniform pick among each token's windows, in order, from
        one batch of uniforms (unpopulated tokens resolved to their
        nearest populated neighbour)."""
        resolved = [self._resolve(int(t))
                    for t in np.asarray(tokens, np.int64).reshape(-1)]
        sizes = np.array([len(self._index[t]) for t in resolved], np.int64)
        offs = (self._rng.random(len(resolved)) * sizes).astype(np.int64)
        return np.array([self._index[t][o]
                         for t, o in zip(resolved, offs)], np.int32)

    def _resolve(self, t: int) -> int:
        """An unpopulated or out-of-range token -> its nearest populated
        neighbour by codebook distance (cached)."""
        if t < len(self._index) and len(self._index[t]):
            return t
        hit = self._resolve_cache.get(t)
        if hit is None:
            cb, pop = self._codebook, self._populated
            d = np.sum((cb[pop] - cb[min(t, len(cb) - 1)]) ** 2, axis=1)
            hit = int(pop[np.argmin(d)])
            self._resolve_cache[t] = hit
        return hit

    def pick_indices_continuity(self, tokens,
                                prev_pick: int = -1) -> np.ndarray:
        """Motion matching: among each token's windows, the one whose
        first latent frame is nearest the previous pick's last latent
        frame; the first token of a chain (prev_pick < 0) takes a uniform
        random pick. prev_pick carries a chain across calls."""
        toks = np.asarray(tokens, np.int64).reshape(-1)
        picks = np.empty(len(toks), np.int32)
        prev = int(prev_pick)
        for i, t in enumerate(toks):
            cand = self._index[self._resolve(int(t))]
            if prev < 0:
                pick = int(cand[self._rng.integers(len(cand))])
            else:
                d = np.sum((self._first_frames[cand]
                            - self._last_frames[prev]) ** 2, axis=1)
                pick = int(cand[np.argmin(d)])
            picks[i] = pick
            prev = pick
        return picks
