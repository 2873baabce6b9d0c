"""Prompt editing / scheduling — `[from:to:when]` and `[a|b]` alternation.

The reference supports these because conditioning flows through A1111's
``get_learned_conditioning`` and is re-materialised every step
(t2v_pipeline.py:406-407, general_utils.py:27-30). Here the prompt is
resolved at every sampling step ahead of time, each *unique* resolved
prompt is encoded once, and a per-step index array is emitted — the
sampler's step loop gathers from the stacked cond table (see
diffusion/sampling.py ``_cond_at``). The port's own copy of the JAX
package's ``text/schedule.py``.

Supported grammar (resolved innermost-out, matching A1111 behaviour):
  [from:to:when]  — steps 1..when use "from", when+1.. use "to";
                    fractional when < 1 means floor(when*steps)
  [to:when]       — "to" is added after step when
  [from::when]    — "from" is removed after step when
  [a|b|c]         — alternates per step: step s uses options[(s-1) % n]
"""

from __future__ import annotations

import re
from dataclasses import dataclass

_re_sched = re.compile(r"\[([^\[\]|]*?):(?:([^\[\]|]*?):)?\s*([\d.]+)\s*\]")
_re_alt = re.compile(r"\[([^\[\]]*\|[^\[\]]*)\]")


def resolve_prompt_at_step(prompt: str, step: int, total_steps: int) -> str:
    """Resolve all scheduling constructs for 1-indexed sampling step."""
    prev = None
    while prev != prompt:
        prev = prompt

        def sub_sched(m: re.Match) -> str:
            if m.group(2) is None:
                before, after = "", m.group(1)  # [to:when]
            else:
                before, after = m.group(1), m.group(2)  # [from:to:when]
            when = float(m.group(3))
            boundary = int(when * total_steps) if when < 1 else int(when)
            return before if step <= boundary else after

        prompt = _re_sched.sub(sub_sched, prompt)

        def sub_alt(m: re.Match) -> str:
            options = m.group(1).split("|")
            return options[(step - 1) % len(options)]

        prompt = _re_alt.sub(sub_alt, prompt)
    return prompt


@dataclass(frozen=True)
class PromptSchedule:
    """Per-step resolved prompts, deduplicated.

    prompts: unique resolved prompt strings, in first-use order
    index:   length ``steps``; index[i] is the prompt for step i+1
    """

    prompts: tuple[str, ...]
    index: tuple[int, ...]

    @property
    def is_static(self) -> bool:
        return len(self.prompts) == 1


def parse_prompt_schedule(prompt: str, steps: int) -> PromptSchedule:
    uniq: list[str] = []
    index: list[int] = []
    for step in range(1, steps + 1):
        resolved = resolve_prompt_at_step(prompt, step, steps)
        if resolved not in uniq:
            uniq.append(resolved)
        index.append(uniq.index(resolved))
    return PromptSchedule(tuple(uniq), tuple(index))
