"""Requests drawn from the run's seed, as a traffic file's ``prompt``
parameters say.

Each request i gets a numpy generator seeded with (run seed, i): a prompt of
words from the traffic's word list, a share of them written ``(word:w)``
with a weight from ``emphasis_weights``, drawn until its token count lies
in ``tokens`` (so that every prompt is one 77-token chunk), and a latent
seed below 2**31. The same run seed gives the same requests.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.text import Tokenizer, emphasis_segments


def request_rng(run_seed: int, i: int, stream: int = 0) -> np.random.Generator:
    return np.random.default_rng([int(run_seed) % (1 << 63), int(i), int(stream)])


def tokens_of(tok: Tokenizer, prompt: str) -> int:
    return sum(len(tok.encode(t)) for t, _ in emphasis_segments(prompt))


def prompt(params: dict, tok: Tokenizer, rng: np.random.Generator) -> str:
    lo, hi = params["tokens"]
    words = params["words"]
    out: list[str] = []
    while True:
        w = words[int(rng.integers(len(words)))]
        if rng.random() < params["emphasis_share"]:
            w = f"({w}:{params['emphasis_weights'][int(rng.integers(len(params['emphasis_weights'])))]})"
        trial = " ".join(out + [w])
        n = tokens_of(tok, trial)
        if n > hi:
            if tokens_of(tok, " ".join(out)) >= lo:
                return " ".join(out)
            out = []
            continue
        out.append(w)
        if n >= lo and rng.random() < params.get("stop_share", 0.3):
            return " ".join(out)


def request(params: dict, tok: Tokenizer, run_seed: int, i: int) -> tuple[str, int]:
    """(prompt, latent seed) of request ``i``."""
    rng = request_rng(run_seed, i)
    p = prompt(params, tok, rng)
    return p, int(rng.integers(0, 1 << 31))
