"""Self-contained CLIP BPE tokenizer (no open_clip / transformers / network).

The reference reaches tokenization through ``open_clip.tokenize`` inside its
A1111 prompt pipeline (clip_hardcode.py:59-145). This is a from-scratch
implementation of the same byte-level BPE scheme:

  * byte→printable-unicode table, lowercasing, whitespace collapsing,
    html unescaping, and a conservative ftfy-equivalent mojibake repair
    (open_clip's ``basic_clean`` runs ``ftfy.fix_text`` first; ftfy is not
    available offline, so ``_fix_mojibake`` reimplements its core
    UTF-8-decoded-as-cp1252/latin-1 fix — whole-string, iterated to a
    fixpoint, strictly round-trip-gated so well-formed text is never
    altered. Remaining delta vs ftfy: per-segment repair of mixed-encoding
    strings and the long tail of normalisation fixes — see
    tests/test_tokenizer_goldens.py for the pinned behaviour);
  * the standard CLIP split regex (contractions, letters, numbers,
    punctuation runs);
  * greedy lowest-rank merge loop with the ``</w>`` end-of-word marker.

The merge table loads from the standard ``bpe_simple_vocab_16e6.txt.gz``
(special ids BOS 49406, EOS 49407, vocab 49408; place it in the model dir
or pass an explicit path). ``CLIPTokenizer.for_tests`` builds a
deterministic toy vocab for random-weight pipelines, as the JAX package's
``random_init`` does.

The port's own copy of the JAX package's ``text/tokenizer.py``. The split
regex there needs the third-party ``regex`` module for ``\\p{L}`` and
``\\p{N}``; here ``split_words`` scans the same alternation by Unicode
category with the standard library alone.
"""

from __future__ import annotations

import gzip
import html
import os
import re
import unicodedata
from functools import lru_cache

# the alternatives tried first at every position of the CLIP split regex
# <\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+
_LITERALS = ("<|startoftext|>", "<|endoftext|>", "'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _char_class(ch: str) -> str:
    """'L' letter, 'N' number, 'S' whitespace, 'O' anything else."""
    major = unicodedata.category(ch)[0]
    if major in ("L", "N"):
        return major
    return "S" if ch.isspace() else "O"


def split_words(text: str) -> list[str]:
    """The CLIP split of lower-cased text: the special tokens and
    contractions, runs of letters, single numbers, runs of other
    non-space characters."""
    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        lit = next((s for s in _LITERALS if text.startswith(s, i)), None)
        if lit is not None:
            out.append(lit)
            i += len(lit)
            continue
        cls = _char_class(text[i])
        if cls == "S":
            i += 1
            continue
        j = i + 1
        if cls != "N":
            while j < n and _char_class(text[j]) == cls:
                j += 1
        out.append(text[i:j])
        i = j
    return out


@lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _has_mojibake_marker(raw: bytes) -> bool:
    """True when ``raw`` (the text re-encoded as cp1252/latin-1 bytes)
    contains a sequence characteristic of ACTUAL mojibake, mirroring
    ftfy's conservatism about plausible-text cases: the common 2-byte
    UTF-8 leads (0xC2/0xC3 → "Ã©"-style Latin-1, 0xD0/0xD1 → Cyrillic)
    followed by a continuation byte, or any 3/4-byte lead (0xE0–0xF4,
    e.g. "â€™", CJK) followed by TWO continuation bytes. A lone rare
    2-byte lead like "Ä©" (0xC4 0xA9 — plausible intended text) does NOT
    qualify, so it round-trips unchanged."""
    n = len(raw)
    for i, b in enumerate(raw):
        if b in (0xC2, 0xC3, 0xD0, 0xD1):
            if i + 1 < n and 0x80 <= raw[i + 1] <= 0xBF:
                return True
        elif 0xE0 <= b <= 0xF4:
            if (
                i + 2 < n
                and 0x80 <= raw[i + 1] <= 0xBF
                and 0x80 <= raw[i + 2] <= 0xBF
            ):
                return True
    return False


def _fix_mojibake(text: str) -> str:
    """ftfy's core repair (open_clip basic_clean runs ftfy.fix_text,
    clip_hardcode.py:59-145 reaches it via open_clip.tokenize): text that
    is UTF-8 bytes mis-decoded as cp1252/latin-1 ("cafÃ©" → "café").
    Strictly gated on a successful round-trip AND on the presence of a
    characteristic mojibake marker sequence (``_has_mojibake_marker``), so
    well-formed text — emoji, non-Latin scripts, and plausible-but-rare
    Latin pairs like "Ä©" — passes through byte-identical. Iterates for
    doubly-encoded input."""
    for _ in range(3):
        if not any(ord(c) > 127 for c in text):
            return text
        candidate = None
        for enc in ("cp1252", "latin-1"):
            try:
                raw = text.encode(enc)
                if not _has_mojibake_marker(raw):
                    return text
                candidate = raw.decode("utf-8")
                break
            except (UnicodeEncodeError, UnicodeDecodeError):
                continue
        if candidate is None or candidate == text:
            return text
        text = candidate
    return text


def _clean(text: str) -> str:
    text = _fix_mojibake(text)
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip()


class CLIPTokenizer:
    def __init__(self, merges: list[tuple[str, str]]):
        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.bos_id = self.encoder["<|startoftext|>"]
        self.eos_id = self.encoder["<|endoftext|>"]
        self.vocab_size = len(vocab)
        self._bpe_cache: dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    # ---- constructors -----------------------------------------------------

    @classmethod
    def from_vocab_file(cls, path: str) -> "CLIPTokenizer":
        """Load the standard gzip merge list (49152-256-2+1 lines used)."""
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        lines = lines[1 : 49152 - 256 - 2 + 1]
        # tolerate short/truncated files: only well-formed "a b" pairs count
        merges = [m for m in (tuple(l.split()) for l in lines) if len(m) == 2]
        tok = cls(merges)
        # remembered so savers (e.g. native checkpoints) can ship the vocab
        tok.source_path = os.path.abspath(path)
        return tok

    @classmethod
    def find_and_load(cls, *search_dirs: str) -> "CLIPTokenizer":
        names = ("bpe_simple_vocab_16e6.txt.gz", "bpe_simple_vocab_16e6.txt")
        for d in search_dirs:
            for n in names:
                p = os.path.join(d, n)
                if os.path.exists(p):
                    return cls.from_vocab_file(p)
        raise FileNotFoundError(
            f"CLIP BPE vocab not found in {search_dirs}; place "
            "bpe_simple_vocab_16e6.txt.gz in the model directory"
        )

    @classmethod
    def for_tests(cls) -> "CLIPTokenizer":
        """Deterministic toy vocab: a few common-word merges, rest falls
        back to byte tokens. NOT CLIP-compatible — unit tests only."""
        words = [
            "the", "cat", "dog", "a", "photo", "of", "in", "forest",
            "bunny", "masterpiece", "watermark", "text", "blurry",
        ]
        merges: list[tuple[str, str]] = []
        for w in words:
            # build left-to-right merges: (t, h) (th, e</w>) ...
            parts = list(w[:-1]) + [w[-1] + "</w>"]
            while len(parts) > 1:
                merges.append((parts[0], parts[1]))
                parts = ["".join(parts[0:2])] + parts[2:]
        seen = set()
        uniq = [m for m in merges if not (m in seen or seen.add(m))]
        return cls(uniq)

    # ---- BPE --------------------------------------------------------------

    def _bpe(self, token: str) -> str:
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word[:-1], word[1:]))
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = set(zip(word[:-1], word[1:]))
        out = " ".join(word)
        self._bpe_cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        """Plain token ids, no BOS/EOS (chunking adds those)."""
        ids: list[int] = []
        text = _clean(text).lower()
        for token in split_words(text):
            btok = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            for sub in self._bpe(btok).split(" "):
                ids.append(self.encoder[sub])
        return ids

    def decode(self, ids: list[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        raw = bytearray()
        for ch in text.replace("</w>", " "):
            if ch in byte_decoder:
                raw.append(byte_decoder[ch])
            else:
                raw.extend(ch.encode("utf-8"))
        return raw.decode("utf-8", errors="replace").strip()
