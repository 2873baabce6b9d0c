"""Error placeholder video.

The reference ships a hardcoded base64 error.mp4 shown when generation
fails (error_hardcode.py, render.py:35-37). We synthesise an equivalent
clip on demand (red banner + 'ERROR' glyphs drawn with cv2) and return the
same data-URL shape, so API/UI consumers observe identical behaviour
without a binary blob in the source tree. The port's copy of the JAX
package's ``media/error_video.py``, with ``cv2`` imported at use.
"""

from __future__ import annotations

import functools
import os
import tempfile

import numpy as np

from t2v_torch.media.video import ffmpeg_stitch_video, video_to_data_url


@functools.lru_cache(maxsize=1)
def get_error_video_data_url(width: int = 256, height: int = 256) -> str:
    import cv2

    frames = []
    for i in range(12):
        img = np.zeros((height, width, 3), np.uint8)
        img[..., 0] = 120  # dark red in RGB
        pulse = int(40 * abs((i % 6) - 3) / 3)
        cv2.putText(
            img,
            "ERROR",
            (width // 8, height // 2),
            cv2.FONT_HERSHEY_SIMPLEX,
            width / 256.0 * 1.4,
            (255, 200 + pulse, 200 + pulse),
            2,
            cv2.LINE_AA,
        )
        frames.append(img)
    # per-process name: a shared fixed path races concurrent workers and
    # fails on multi-user hosts
    path = os.path.join(tempfile.gettempdir(), f"t2v_error_{os.getpid()}.mp4")
    ffmpeg_stitch_video(frames=frames, out_path=path, fps=6)
    return video_to_data_url(path)
