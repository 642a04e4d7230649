"""Data pipeline: deterministic synthetic LM streams and a text-file
corpus, the port's copy of ``repro/training/data.py``.

Synthetic mode draws structured pseudo-text (Zipfian unigrams and a
Markov bigram chain) so the loss falls over a short run; file mode
tokenizes a UTF-8 corpus with the byte tokenizer and yields packed
blocks.  The batches are numpy arrays, byte-identical to the
reference's: the same draws from the same ``np.random.Generator`` in the
same order.  ``_stream`` stays a Python loop for that reason: the draw
count depends on each coin, and ``rng.choice`` over the 32,000-entry
Zipf table for about a fifth of the tokens makes a 4 x 2048 batch cost
a few tenths of a second on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.serving.tokenizer import ByteTokenizer


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    path: str | None = None     # optional text-file corpus
    d_model: int = 0            # for frontend stubs
    num_image_tokens: int = 0
    is_encoder_decoder: bool = False
    arch_type: str = "dense"


class SyntheticLM:
    """Zipf unigram + bigram-chain synthetic language."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # sparse deterministic bigram successor table
        self._succ = rng.integers(0, v, size=(v, 4))
        self._zipf_p = 1.0 / np.arange(1, v + 1)
        self._zipf_p /= self._zipf_p.sum()
        # ``rng.choice(v, p=p)`` draws one uniform and searches this CDF;
        # built once here, not on every draw (O(vocab) each)
        self._zipf_cdf = self._zipf_p.cumsum()
        self._zipf_cdf /= self._zipf_cdf[-1]

    def _stream(self, rng: np.random.Generator, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.int32)
        tok = int(rng.integers(0, self.cfg.vocab_size))
        for i in range(n):
            out[i] = tok
            if rng.random() < 0.8:  # follow bigram structure
                tok = int(self._succ[tok, rng.integers(0, 4)])
            else:
                tok = int(self._zipf_cdf.searchsorted(rng.random(),
                                                      side="right"))
        return out

    def batches(self) -> Iterator[dict]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + 1)
        while True:
            toks = np.stack([
                self._stream(rng, cfg.seq_len) for _ in range(cfg.batch_size)
            ])
            yield _attach_frontends(cfg, toks, rng)


class TextFileLM:
    """Packed blocks from a UTF-8 text file via the byte tokenizer."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        tk = ByteTokenizer(cfg.vocab_size, add_bos=False)
        with open(cfg.path, encoding="utf-8") as f:
            self.ids = np.asarray(tk.encode(f.read()), dtype=np.int32)
        if len(self.ids) < cfg.seq_len + 1:
            reps = (cfg.seq_len + 1) // max(len(self.ids), 1) + 1
            self.ids = np.tile(self.ids, reps)

    def batches(self) -> Iterator[dict]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        hi = len(self.ids) - cfg.seq_len - 1
        while True:
            starts = rng.integers(0, hi, size=cfg.batch_size)
            toks = np.stack([self.ids[s: s + cfg.seq_len] for s in starts])
            yield _attach_frontends(cfg, toks, rng)


def _attach_frontends(cfg: DataConfig, toks: np.ndarray,
                      rng: np.random.Generator) -> dict:
    batch = {"tokens": toks, "targets": toks}
    if cfg.num_image_tokens and cfg.arch_type == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (cfg.batch_size, cfg.num_image_tokens, cfg.d_model)
        ).astype(np.float32) * 0.1
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (cfg.batch_size, cfg.seq_len, cfg.d_model)
        ).astype(np.float32) * 0.5
    return batch


def make_dataset(cfg: DataConfig):
    return TextFileLM(cfg) if cfg.path else SyntheticLM(cfg)
