"""The port's keyframe DSL (``pipeline/keyframes.py``, numpy and scipy in
place of pandas) against the JAX package's pandas-based copy: Linear,
Quadratic and Cubic interpolation (with the reference's degradation for few
keys), expression values and expression frame indices, the reference quirk
that an expression keeps evaluating until the next numeric key, integer
output, the inpainting weights of a request, and the evaluator's refusals.
Both sides fill the same float64 series, so the values agree to float32
rounding (rtol 1e-6).
"""

import numpy as np
import pytest

from t2v.pipeline import keyframes as jkf
from t2v_torch.pipeline import keyframes as tkf
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

STRINGS = [
    '0:(t/max_i_f), "max_i_f":(1)',                 # the default inpainting weights
    "0:(1), 5:(0.2), 9:(0.8), 15:(0)",              # four numeric keys
    "0:(0), 7:(1)",                                 # two keys: Quadratic/Cubic fall to Linear
    "0:(0.5), 6:(1), 12:(0)",                       # three keys: Cubic falls to Quadratic
    "0:(t/max_f), 6:(0.5), 11:(1), 15:(0.25)",      # an expression, then numbers (the quirk)
    "3:(0.2), max_f-2:(0.9)",                       # expression index; ends filled from the keys
    "0:(s/10), 8:(t*t/100)",                        # the seed and a later expression
    "0:(1), 4:(0.5), 8:(0.25), 10:(0), 13:(0.5)",   # five keys
]


@pytest.mark.parametrize("method", ["Linear", "Quadratic", "Cubic"])
@pytest.mark.parametrize("string", STRINGS)
def test_inbetweens_match_jax(string, method):
    frames, inpaint, seed = 16, 8, 3
    keys = tkf.parse_key_frames(string, max_frames=frames, max_i_frames=inpaint, seed=seed)
    assert keys == jkf.parse_key_frames(string, max_frames=frames, max_i_frames=inpaint,
                                        seed=seed)
    got = tkf.KeyFrameSeries(frames, seed, inpaint).get_inbetweens(keys, interp_method=method)
    want = jkf.KeyFrameSeries(frames, seed, inpaint).get_inbetweens(keys, interp_method=method)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_integer_output_matches_jax():
    keys = {0: "0", 7: "10.7", 15: "3"}
    got = tkf.KeyFrameSeries(16).get_inbetweens(keys, integer=True, interp_method="Quadratic")
    want = jkf.KeyFrameSeries(16).get_inbetweens(keys, integer=True, interp_method="Quadratic")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frames,inpaint", [(24, 12), (8, 1), (5, 5)])
def test_inpainting_weights_match_jax(frames, inpaint):
    weights = '0:(t/max_i_f), "max_i_f":(1)'
    got = tkf.KeyFrameSeries(frames, 7, inpaint).inpainting_weights(weights)
    want = jkf.KeyFrameSeries(frames, 7, inpaint).inpainting_weights(weights)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("expr", ["__import__('os')", "t.real", "[1, 2]", "lambda: 1", "u + 1"])
def test_safe_eval_refuses_what_the_jax_copy_refuses(expr):
    with pytest.raises(ValueError):
        tkf.safe_eval(expr, {"t": 1.0})
    with pytest.raises(ValueError):
        jkf.safe_eval(expr, {"t": 1.0})


def test_safe_eval_matches_jax():
    for expr in ("t/max_f", "sin(t) * 2 + 1", "max(t, 3) if t > 2 else -1", "2 ** 3 % 5", "-t"):
        env = {"t": 4.0, "max_f": 15.0}
        assert tkf.safe_eval(expr, env) == jkf.safe_eval(expr, env)


def test_malformed_strings_raise_as_in_jax():
    for mod in (tkf, jkf):
        with pytest.raises(RuntimeError, match="not correctly formatted"):
            mod.parse_key_frames(",", max_frames=4)
