"""Transport-agnostic /t2v request handlers of the port.

ONE implementation of argument building, upload handling, run invocation,
metadata reading, and error→status mapping — shared by the FastAPI app
(``api/app.py``) and the dependency-free stdlib server
(``api/stdlib_server.py``), so that their status codes and response
shapes cannot drift. The port's copy of the JAX package's
``api/handlers.py``, on the port's ``run``; ``device`` says where a model
loaded by name runs (the card by default).

Schema parity with the reference WebAPI (api_t2v.py:49-193): defaults from
``T2VArgs()``/``T2VOutputArgs()`` overridden by non-None query params,
multipart uploads written to ``outputs/t2v_temp/<uuid>`` and cleaned up in
``finally``, ``{"mp4s": [dataurl...]}`` on success, 422 on validation
errors, 500 with the reference's detail string on processing errors.
"""

from __future__ import annotations

import os
import threading
import traceback
import uuid
from dataclasses import dataclass
from typing import Any, Mapping, Optional

import t2v_torch
from t2v_torch.core.config import T2VArgs, T2VOutputArgs, sanity_check_args
from t2v_torch.core.state import state

API_VERSION = "1.0"

# Generation-job serialization. The reference's one real concurrency
# mechanism is A1111's GPU-call queue (wrap_gradio_gpu_call,
# text2vid.py:82): generate jobs run one at a time no matter how many
# clients click. Both of our transports are threaded, so the equivalent
# queue lives here, shared by the FastAPI app and the stdlib server: a
# second POST /t2v/run blocks until the running job finishes. This also
# protects every piece of shared mutable state a job touches — the
# module-global JobState (core/state.py), the warm-pipe global
# (pipeline/run.py), and the text encoder's request-level settings
# (pipeline.py infer) — and makes interrupt/skip well-defined:
# they always target the RUNNING job, because run() resets the shared
# JobState only after acquiring this lock.
_run_lock = threading.Lock()

# transport-level upload cap (the /t2v/metadata advisor finding: unbounded
# uploads were buffered ~3x in RAM). 1 GiB covers any plausible mp4 upload.
MAX_UPLOAD_BYTES = 1 << 30

_INT_FIELDS = {
    "steps", "frames", "seed", "width", "height", "batch_count",
    "vid2vid_startFrame", "inpainting_frames", "fps",
    "comma_padding_backtrack", "cond_fps",
}
_FLOAT_FIELDS = {"cfg_scale", "eta", "strength"}
_BOOL_FIELDS = {"do_vid2vid", "enable_emphasis"}
_OUT_FIELDS = ("fps", "add_soundtrack", "soundtrack_path")


@dataclass
class ApiResponse:
    status: int
    payload: dict


def coerce(name: str, value: Any):
    """Query-string → typed value; typed values (FastAPI already coerces)
    pass through unchanged."""
    if not isinstance(value, str):
        return value
    if name in _INT_FIELDS:
        return int(value)
    if name in _FLOAT_FIELDS:
        return float(value)
    if name in _BOOL_FIELDS:
        return value.lower() in ("1", "true", "yes", "on")
    return value


def version_payload() -> dict:
    return {"version": t2v_torch.__version__}


def api_version_payload() -> dict:
    return {"version": API_VERSION}


def progress_payload() -> dict:
    return {
        "job": state.job,
        "job_no": state.job_no,
        "job_count": state.job_count,
        "sampling_step": state.sampling_step,
        "sampling_steps": state.sampling_steps,
        "interrupted": state.interrupted,
    }


def interrupt_response() -> ApiResponse:
    state.interrupt()
    return ApiResponse(200, {"interrupted": True})


def skip_response() -> ApiResponse:
    state.skip()
    return ApiResponse(200, {"skipped": True})


def metadata_response(blob: Optional[bytes]) -> ApiResponse:
    """MP4 ©cmt metadata viewer (reference UI accordion, args.py:160-175)."""
    import tempfile

    from t2v_torch.media.video import read_mp4_metadata_comment

    if blob is None:
        return ApiResponse(422, {"detail": "no file uploaded"})
    if len(blob) > MAX_UPLOAD_BYTES:
        return ApiResponse(413, {"detail": "uploaded file too large"})
    with tempfile.NamedTemporaryFile(suffix=".mp4") as tmp:
        tmp.write(blob)
        tmp.flush()
        comment = read_mp4_metadata_comment(tmp.name)
    return ApiResponse(200, {"comment": comment})


def build_args(query: Mapping[str, Any]) -> tuple[T2VArgs, T2VOutputArgs]:
    """Defaults + non-None overrides (api_t2v.py:82-90). Raises ValueError
    on bad numeric strings. ``model`` is special-cased: an explicit None
    means "reuse the warm pipe" (process_modelscope.py:62-66), so it is
    always forwarded rather than falling back to the default."""
    overrides: dict[str, Any] = {}
    for k, v in query.items():
        if v is None or not hasattr(T2VArgs(), k):
            continue
        try:
            overrides[k] = coerce(k, v)
        except (TypeError, ValueError) as e:
            raise ValueError(f"invalid value for {k!r}: {v!r}") from e
    args = T2VArgs(**overrides)
    if "model" not in overrides:
        args = args.replace(model=None)

    out_overrides = {}
    for k in _OUT_FIELDS:
        v = query.get(k)
        if v is not None:
            try:
                out_overrides[k] = coerce(k, v)
            except (TypeError, ValueError) as e:
                raise ValueError(f"invalid value for {k!r}: {v!r}") from e
    return args, T2VOutputArgs(**out_overrides)


def missing_prompt_response() -> ApiResponse:
    # FastAPI-shaped required-field error, mirrored by the stdlib server
    return ApiResponse(
        422, {"detail": [{"loc": ["query", "prompt"], "msg": "field required"}]}
    )


def run_response(
    query: Mapping[str, Any],
    uploads: Mapping[str, bytes],
    pipe=None,
    device: str = "cuda",
) -> ApiResponse:
    """The POST /t2v/run body shared by both transports."""
    from t2v_torch.pipeline.run import run

    if query.get("prompt") is None:
        return missing_prompt_response()
    for blob in uploads.values():
        if blob is not None and len(blob) > MAX_UPLOAD_BYTES:
            return ApiResponse(413, {"detail": "uploaded file too large"})

    tmp_dir = os.path.join("outputs", "t2v_temp")
    tmp_files: list[str] = []
    try:
        args, out_args = build_args(query)
        sanity_check_args(args)

        os.makedirs(tmp_dir, exist_ok=True)
        if args.inpainting_frames > 0 and uploads.get("inpainting_image") is not None:
            p = os.path.join(tmp_dir, f"{uuid.uuid4()}.png")
            with open(p, "wb") as f:
                f.write(uploads["inpainting_image"])
            tmp_files.append(p)
            args = args.replace(inpainting_image=p)
        if args.do_vid2vid and uploads.get("vid2vid_input") is not None:
            p = os.path.join(tmp_dir, f"{uuid.uuid4()}.mp4")
            with open(p, "wb") as f:
                f.write(uploads["vid2vid_input"])
            tmp_files.append(p)
            args = args.replace(vid2vid_input=p)

        # additive request knobs that ride beside the reference schema
        inpaint_mode = query.get("inpaint_mode") or "initial_only"
        if inpaint_mode not in ("initial_only", "progressive"):
            return ApiResponse(422, {"detail": f"invalid inpaint_mode {inpaint_mode!r}"})
        vc_sample_type = query.get("vc_sample_type") or "ddim"
        vc_uc_type = query.get("uc_type") or None
        # reference 3-state keep-in-VRAM webui option (text2vid.py:93)
        keep_in_vram = query.get("keep_in_vram")
        if keep_in_vram is None:
            keep_in_vram = True

        # one generate job at a time (the reference's wrap_gradio_gpu_call
        # queue, text2vid.py:82) — concurrent requests wait here
        with _run_lock:
            result = run(
                args, out_args, pipe=pipe, inpaint_mode=inpaint_mode,
                vc_sample_type=vc_sample_type, vc_uc_type=vc_uc_type,
                keep_in_vram=keep_in_vram, device=device,
            )
        return ApiResponse(200, {"mp4s": result.data_urls})
    except ValueError as e:
        return ApiResponse(422, {"detail": str(e)})
    except Exception as e:
        traceback.print_exc()
        return ApiResponse(
            500, {"detail": "An error occurred while processing the video."}
        )
    finally:
        for p in tmp_files:
            try:
                os.remove(p)
            except OSError:
                pass
