"""FastAPI WebAPI of the port — the reference's /t2v endpoints,
schema-compatible.

Mirrors api_t2v.py:
  * ``GET /t2v/api_version`` → {"version": "1.0"} (:62-64)
  * ``GET /t2v/version``     → framework version (:66-68; the reference
    reports its git commit via A1111)
  * ``POST /t2v/run``        → same query parameters (:70-74), multipart
    uploads for ``vid2vid_input`` / ``inpainting_image`` (:99-120),
    response ``{"mp4s": ["data:video/mp4;base64,..."]}`` (:169),
    422 on validation error (:54-59), 500 JSON with the same detail string
    on processing error (:170-177), temp-file cleanup in finally (:178-193).

Additional endpoints (new surface, additive only):
  * ``POST /t2v/interrupt`` / ``POST /t2v/skip`` — cooperative cancel,
    the API-shaped equivalent of the reference UI's buttons;
  * ``GET /t2v/progress`` — sampling progress (A1111 progress API role).

This module is a thin FastAPI *transport*: every request body/semantics
lives in ``t2v_torch.api.handlers``, shared verbatim with the stdlib server
so the two cannot drift. FastAPI is imported only inside ``create_app``.
The port's copy of the JAX package's ``api/app.py``.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Union

from t2v_torch.api.handlers import API_VERSION  # re-export (stdlib server imports it)

logger = logging.getLogger("t2v_torch.api")

__all__ = ["API_VERSION", "create_app"]


def create_app(pipe=None, models_root: Optional[str] = None, device: str = "cuda"):
    from fastapi import FastAPI, Request, UploadFile
    from fastapi.encoders import jsonable_encoder
    from fastapi.exceptions import RequestValidationError
    from fastapi.responses import JSONResponse

    import t2v_torch
    from t2v_torch.api import handlers

    if models_root:
        os.environ["T2V_MODELS_ROOT"] = models_root

    app = FastAPI(title="t2v_torch", version=t2v_torch.__version__)

    def _send(resp: handlers.ApiResponse) -> JSONResponse:
        return JSONResponse(status_code=resp.status, content=resp.payload)

    @app.exception_handler(RequestValidationError)
    async def validation_exception_handler(request: Request, exc: RequestValidationError):
        return JSONResponse(
            status_code=422,
            content=jsonable_encoder({"detail": exc.errors(), "body": exc.body}),
        )

    @app.get("/")
    async def index():
        from fastapi.responses import HTMLResponse

        from t2v_torch.api.webui import INDEX_HTML

        return HTMLResponse(content=INDEX_HTML)

    @app.get("/t2v/api_version")
    async def t2v_api_version():
        return JSONResponse(content=handlers.api_version_payload())

    @app.get("/t2v/version")
    async def t2v_version():
        return JSONResponse(content=handlers.version_payload())

    @app.get("/t2v/progress")
    async def t2v_progress():
        return JSONResponse(content=handlers.progress_payload())

    @app.post("/t2v/interrupt")
    async def t2v_interrupt():
        return _send(handlers.interrupt_response())

    @app.post("/t2v/skip")
    async def t2v_skip():
        return _send(handlers.skip_response())

    @app.post("/t2v/metadata")
    async def t2v_metadata(file: UploadFile):
        blob = await file.read(handlers.MAX_UPLOAD_BYTES + 1)
        return _send(handlers.metadata_response(blob))

    @app.post("/t2v/run")
    async def t2v_run(
        prompt: str,
        n_prompt: Union[str, None] = None,
        model: Union[str, None] = None,
        model_type: Union[str, None] = None,
        sampler: Union[str, None] = None,
        steps: Union[int, None] = None,
        frames: Union[int, None] = None,
        seed: Union[int, None] = None,
        cfg_scale: Union[float, None] = None,
        width: Union[int, None] = None,
        height: Union[int, None] = None,
        eta: Union[float, None] = None,
        batch_count: Union[int, None] = None,
        do_vid2vid: bool = False,
        vid2vid_input: Union[UploadFile, None] = None,
        strength: Union[float, None] = None,
        vid2vid_startFrame: Union[int, None] = None,
        inpainting_image: Union[UploadFile, None] = None,
        inpainting_frames: Union[int, None] = None,
        inpainting_weights: Union[str, None] = None,
        cond_fps: Union[int, None] = None,
        fps: Union[int, None] = None,
        add_soundtrack: Union[str, None] = None,
        soundtrack_path: Union[str, None] = None,
        comma_padding_backtrack: Union[int, None] = None,
        enable_emphasis: Union[bool, None] = None,
        inpaint_mode: Union[str, None] = None,
        vc_sample_type: Union[str, None] = None,
        uc_type: Union[str, None] = None,
        keep_in_vram: Union[str, None] = None,
    ):
        query = dict(
            prompt=prompt, n_prompt=n_prompt, model=model,
            model_type=model_type, sampler=sampler,
            steps=steps, frames=frames, seed=seed, cfg_scale=cfg_scale,
            width=width, height=height, eta=eta, batch_count=batch_count,
            do_vid2vid=do_vid2vid, strength=strength,
            vid2vid_startFrame=vid2vid_startFrame,
            inpainting_frames=inpainting_frames,
            inpainting_weights=inpainting_weights,
            cond_fps=cond_fps,
            fps=fps, add_soundtrack=add_soundtrack,
            soundtrack_path=soundtrack_path,
            comma_padding_backtrack=comma_padding_backtrack,
            enable_emphasis=enable_emphasis,
            inpaint_mode=inpaint_mode,
            vc_sample_type=vc_sample_type, uc_type=uc_type,
            keep_in_vram=keep_in_vram,
        )
        uploads: dict[str, bytes] = {}
        if inpainting_image is not None:
            uploads["inpainting_image"] = await inpainting_image.read(
                handlers.MAX_UPLOAD_BYTES + 1
            )
        if vid2vid_input is not None:
            uploads["vid2vid_input"] = await vid2vid_input.read(
                handlers.MAX_UPLOAD_BYTES + 1
            )

        # off the event loop: generation takes minutes, and /t2v/progress
        # + /t2v/interrupt must stay responsive while it runs
        import anyio

        resp = await anyio.to_thread.run_sync(
            lambda: handlers.run_response(query, uploads, pipe=pipe, device=device)
        )
        return _send(resp)

    return app
