"""A1111-compatible 75-token prompt chunking — pure functions.

Behavioural spec (pinned by tests/test_text.py and
tests/data/chunking_golden.json; reference: clip_hardcode.py:146-239):
emphasis-parsed segments are tokenized and packed into rows of 75 ids
wrapped with BOS/EOS, where

  * the ``BREAK`` keyword seals the current row early (:190-192);
  * if a row fills within ``comma_backtrack`` ids of its most recent
    comma, everything after that comma migrates to the next row
    (:203-214; A1111 default backtrack = 20);
  * each id carries an emphasis multiplier (:219-223);
  * SD2-style padding replaces everything after the first EOS with
    id_pad=0 (process_tokens :404-408).

Implementation shape: each prompt line is first flattened into a stream of
events (plain id / break marker), then a ``_RowPacker`` folds the stream
into sealed 77-wide rows. The packer owns all boundary bookkeeping; the
event pass owns parsing (emphasis weights). Textual-inversion embedding
splices (find_embedding_at_position :219-234) are not part of the port
yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from t2v_torch.text.prompt_parser import parse_prompt_attention
from t2v_torch.text.tokenizer import CLIPTokenizer

CHUNK_LENGTH = 75
DEFAULT_COMMA_BACKTRACK = 20


@dataclass
class PromptChunk:
    tokens: list[int] = field(default_factory=list)
    multipliers: list[float] = field(default_factory=list)


_BREAK = ("break",)


def _event_stream(line: str, tokenizer: CLIPTokenizer, enable_emphasis: bool) -> Iterator[tuple]:
    """Flatten a prompt line into packer events: ("id", token_id, weight)
    | ("break",)."""
    segments = parse_prompt_attention(line) if enable_emphasis else [[line, 1.0]]
    for text, weight in segments:
        if text == "BREAK" and weight == -1:
            yield _BREAK
            continue
        for token_id in tokenizer.encode(text):
            yield ("id", token_id, weight)


class _RowPacker:
    """Folds an event stream into sealed 77-wide PromptChunks.

    Invariants: ``self.ids``/``self.weights`` never exceed CHUNK_LENGTH
    between events; the raw id count (pre-padding) is tallied the A1111
    way — a full 75 per early-sealed row, the true length for the last.
    """

    def __init__(self, tokenizer: CLIPTokenizer, backtrack: int):
        self.bos = tokenizer.bos_id
        self.eos = tokenizer.eos_id
        self.comma = tokenizer.encoder.get(",</w>")
        self.backtrack = backtrack
        self.rows: list[PromptChunk] = []
        self.ids: list[int] = []
        self.weights: list[float] = []
        self.comma_at = -1  # index of the newest comma in the open row
        self.id_total = 0

    def _seal(self, *, final: bool = False) -> None:
        """Close the open row: pad with EOS to 75, wrap in BOS/EOS."""
        self.id_total += len(self.ids) if final else CHUNK_LENGTH
        short = CHUNK_LENGTH - len(self.ids)
        row = PromptChunk(
            tokens=[self.bos] + self.ids + [self.eos] * (short + 1),
            multipliers=[1.0] + self.weights + [1.0] * (short + 1),
        )
        self.rows.append(row)
        self.ids, self.weights = [], []
        self.comma_at = -1

    def _migrate_past_comma(self) -> None:
        """The row filled close enough to its last comma: seal everything
        up to (and including) the comma, carry the tail into the new row."""
        cut = self.comma_at + 1
        carry_ids, carry_w = self.ids[cut:], self.weights[cut:]
        self.ids, self.weights = self.ids[:cut], self.weights[:cut]
        self._seal()
        self.ids, self.weights = carry_ids, carry_w

    def _push_id(self, token_id: int, weight: float) -> None:
        if token_id == self.comma:
            self.comma_at = len(self.ids)
        elif (
            self.backtrack != 0
            and len(self.ids) == CHUNK_LENGTH
            and self.comma_at != -1
            and len(self.ids) - self.comma_at <= self.backtrack
        ):
            self._migrate_past_comma()
        if len(self.ids) == CHUNK_LENGTH:
            self._seal()
        self.ids.append(token_id)
        self.weights.append(weight)

    def feed(self, events: Iterator[tuple]) -> None:
        for ev in events:
            if ev[0] == "break":
                self._seal()
            else:
                self._push_id(ev[1], ev[2])

    def finish(self) -> tuple[list[PromptChunk], int]:
        if self.ids or not self.rows:
            self._seal(final=True)
        return self.rows, self.id_total


def tokenize_line(
    line: str,
    tokenizer: CLIPTokenizer,
    *,
    enable_emphasis: bool = True,
    comma_backtrack: int = DEFAULT_COMMA_BACKTRACK,
) -> tuple[list[PromptChunk], int]:
    """Returns (chunks, token_count). Every chunk is 77 wide (BOS+75+EOS)."""
    packer = _RowPacker(tokenizer, comma_backtrack)
    packer.feed(_event_stream(line, tokenizer, enable_emphasis))
    return packer.finish()


def pad_after_eos(tokens: np.ndarray, eos: int, pad: int = 0) -> np.ndarray:
    """SD2 padding rule: all positions after the first EOS become id_pad
    (clip_hardcode.py:404-408)."""
    out = tokens.copy()
    for row in out:
        idx = int(np.argmax(row == eos))
        row[idx + 1 :] = pad
    return out
