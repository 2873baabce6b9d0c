"""A1111-compatible prompt emphasis parsing.

The reference feeds prompts through A1111's ``parse_prompt_attention``
(clip_hardcode.py:153-156). This is a from-scratch implementation of that
public grammar:

  (text)        weight × 1.1          [text]      weight ÷ 1.1
  (text:1.3)    explicit weight       \\( \\) \\[ \\]  literals
  BREAK         forces a new 75-token chunk (returned as ("BREAK", -1))

Returns [[text, weight], ...] with adjacent equal-weight runs merged, e.g.
  "a (cat:1.5) in a [forest]" ->
  [["a ", 1.0], ["cat", 1.5], [" in a ", 1.0], ["forest", 1/1.1]]
"""

from __future__ import annotations

import re

_re_attention = re.compile(
    r"""
\\\(|\\\)|\\\[|\\\]|\\\\|\\|\(|\[|:\s*([+-]?[.\d]+)\s*\)|\)|\]|[^\\()\[\]:]+|:
""",
    re.X,
)

_re_break = re.compile(r"\s*\bBREAK\b\s*", re.S)

ROUND_MULT = 1.1
SQUARE_MULT = 1 / 1.1


def parse_prompt_attention(text: str) -> list[list]:
    res: list[list] = []
    round_brackets: list[int] = []
    square_brackets: list[int] = []

    def multiply_range(start: int, multiplier: float):
        for p in range(start, len(res)):
            res[p][1] *= multiplier

    for m in _re_attention.finditer(text):
        tok = m.group(0)
        weight = m.group(1)
        if tok.startswith("\\"):
            res.append([tok[1:], 1.0])
        elif tok == "(":
            round_brackets.append(len(res))
        elif tok == "[":
            square_brackets.append(len(res))
        elif weight is not None and round_brackets:
            multiply_range(round_brackets.pop(), float(weight))
        elif tok == ")" and round_brackets:
            multiply_range(round_brackets.pop(), ROUND_MULT)
        elif tok == "]" and square_brackets:
            multiply_range(square_brackets.pop(), SQUARE_MULT)
        else:
            parts = _re_break.split(tok)
            for i, part in enumerate(parts):
                if i > 0:
                    res.append(["BREAK", -1])
                if part:
                    res.append([part, 1.0])

    # unclosed brackets fall back to their default multipliers
    for pos in round_brackets:
        multiply_range(pos, ROUND_MULT)
    for pos in square_brackets:
        multiply_range(pos, SQUARE_MULT)

    if not res:
        res = [["", 1.0]]

    # merge runs with identical weights
    i = 0
    while i + 1 < len(res):
        if res[i][1] == res[i + 1][1] and res[i][0] != "BREAK" and res[i + 1][0] != "BREAK":
            res[i][0] += res[i + 1][0]
            del res[i + 1]
        else:
            i += 1
    return res
