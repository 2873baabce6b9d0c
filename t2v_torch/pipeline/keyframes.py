"""Keyframe expression DSL for inpainting-mask weights.

The port's copy of the JAX package's ``pipeline/keyframes.py``, without
pandas (the GPU host has numpy and scipy and no pandas). Strings like
``'0:(t/max_i_f), "max_i_f":(1)'`` give per-frame values, where both the
frame index and the value may be math expressions over:

  t        current frame index
  max_f    frames - 1
  max_i_f  inpainting frames - 1
  s        seed

Missing frames are interpolated Linear, Quadratic or Cubic, with the
reference's degradation rules (Cubic -> Quadratic for <= 3 keys,
Quadratic -> Linear for <= 2). Where the JAX package fills the gaps with
``pandas.Series.interpolate(method, limit_direction="both")``, this copy
uses what pandas calls underneath: ``np.interp`` for Linear, and
``scipy.interpolate.interp1d`` over the valid points for Quadratic and
Cubic. Expressions are evaluated by a whitelisted-AST interpreter (names,
numeric literals, arithmetic, comparisons and a small table of math
functions), never by ``eval``.
"""

from __future__ import annotations

import ast
import math
import operator
import re

import numpy as np

_FLOAT_RE = re.compile(r"^(?=.)([+-]?([0-9]*)(\.([0-9]+))?)$")

_BIN_OPS = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod,
    ast.Pow: operator.pow,
}
_UNARY_OPS = {ast.UAdd: operator.pos, ast.USub: operator.neg}
_CMP_OPS = {
    ast.Lt: operator.lt,
    ast.LtE: operator.le,
    ast.Gt: operator.gt,
    ast.GtE: operator.ge,
    ast.Eq: operator.eq,
    ast.NotEq: operator.ne,
}
_FUNCS = {
    "sin": math.sin, "cos": math.cos, "tan": math.tan, "abs": abs,
    "min": min, "max": max, "sqrt": math.sqrt, "exp": math.exp,
    "log": math.log, "floor": math.floor, "ceil": math.ceil,
    "round": round, "pow": pow,
}


def safe_eval(expr: str, variables: dict[str, float]) -> float:
    """Whitelisted math-expression evaluator (numexpr stand-in)."""

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return node.value
        if isinstance(node, ast.Name):
            if node.id in variables:
                return variables[node.id]
            raise ValueError(f"unknown variable {node.id!r}")
        if isinstance(node, ast.BinOp) and type(node.op) in _BIN_OPS:
            return _BIN_OPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARY_OPS:
            return _UNARY_OPS[type(node.op)](ev(node.operand))
        if isinstance(node, ast.Compare) and len(node.ops) == 1 and type(node.ops[0]) in _CMP_OPS:
            return float(_CMP_OPS[type(node.ops[0])](ev(node.left), ev(node.comparators[0])))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id in _FUNCS:
            return _FUNCS[node.func.id](*[ev(a) for a in node.args])
        if isinstance(node, ast.IfExp):
            return ev(node.body) if ev(node.test) else ev(node.orelse)
        raise ValueError(f"disallowed expression element: {ast.dump(node)}")

    return float(ev(ast.parse(expr, mode="eval")))


def _sanitize(value: str) -> str:
    return value.replace("'", "").replace('"', "").replace("(", "").replace(")", "")


def _is_number(value: str) -> bool:
    return bool(_FLOAT_RE.match(value))


def parse_key_frames(string: str, *, max_frames: int, max_i_frames: int = 1, seed: int = -1) -> dict[int, str]:
    """'0:(expr), "max_i_f":(1)' → {frame_index: expr_string}
    (key_frames.py:59-74 semantics: the index itself may be an expression)."""
    variables = {
        "max_f": max_frames - 1,
        "max_i_f": max_i_frames - 1,
        "s": seed,
    }
    frames: dict[int, str] = {}
    for part in string.split(","):
        if not part.strip():
            continue
        key, _, value = part.partition(":")
        key = _sanitize(key.strip())
        frame = int(key) if _is_number(key) else int(safe_eval(key, variables))
        frames[frame] = value.strip()
    if not frames and string:
        raise RuntimeError("Key Frame string not correctly formatted")
    return frames


def _interpolate(series: np.ndarray, method: str) -> np.ndarray:
    """Fill the NaNs of ``series`` (whose ends are set) as
    ``pandas.Series.interpolate(method, limit_direction="both")`` does on a
    0..n-1 index: ``np.interp`` for "linear", ``scipy.interpolate.interp1d``
    over the valid points for "quadratic" and "cubic"."""
    valid = ~np.isnan(series)
    if valid.all():
        return series
    x = np.arange(series.size)
    out = series.copy()
    if method == "linear":
        out[~valid] = np.interp(x[~valid], x[valid], series[valid])
        return out
    if method not in ("quadratic", "cubic"):
        raise ValueError(f"interpolation method {method!r}")
    from scipy.interpolate import interp1d

    out[~valid] = interp1d(x[valid], series[valid], kind=method)(x[~valid])
    return out


class KeyFrameSeries:
    """Interpolated per-frame values (T2VAnimKeys / FrameInterpolater role,
    key_frames.py:9-57)."""

    def __init__(self, max_frames: int, seed: int = -1, max_i_frames: int = 1):
        self.max_frames = max_frames
        self.seed = seed
        self.max_i_frames = max_i_frames

    def get_inbetweens(
        self, key_frames: dict[int, str], *, integer: bool = False, interp_method: str = "Linear"
    ) -> np.ndarray:
        series = np.full(self.max_frames, np.nan)
        base_vars = {
            "max_f": self.max_frames - 1,
            "max_i_f": self.max_i_frames - 1,
            "s": self.seed,
        }
        # reference quirk preserved (key_frames.py:35-45): an expression
        # value keeps evaluating at every later frame until the next
        # numeric key overrides it
        value: str | None = None
        value_is_number = True
        for i in range(self.max_frames):
            if i in key_frames:
                value = key_frames[i]
                value_is_number = bool(_is_number(_sanitize(value)))
                if value_is_number:
                    series[i] = float(_sanitize(value))
            if value is not None and not value_is_number:
                series[i] = safe_eval(_sanitize(value), {**base_vars, "t": i})

        if interp_method == "Cubic" and len(key_frames) <= 3:
            interp_method = "Quadratic"
        if interp_method == "Quadratic" and len(key_frames) <= 2:
            interp_method = "Linear"

        valid = np.flatnonzero(~np.isnan(series))
        series[0] = series[valid[0]]
        series[self.max_frames - 1] = series[valid[-1]]
        out = _interpolate(series, interp_method.lower())
        return out.astype(int) if integer else out.astype(np.float32)

    def inpainting_weights(self, weights_string: str) -> np.ndarray:
        keys = parse_key_frames(
            weights_string,
            max_frames=self.max_frames,
            max_i_frames=self.max_i_frames,
            seed=self.seed,
        )
        return self.get_inbetweens(keys)
