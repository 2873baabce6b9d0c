"""Host-side media of the port: video IO, post-processing, the error clip."""

from t2v_torch.media.video import (
    ffmpeg_stitch_video,
    find_ffmpeg_binary,
    frames_to_video,
    get_quick_vid_info,
    vid2frames,
)

__all__ = [
    "ffmpeg_stitch_video",
    "find_ffmpeg_binary",
    "frames_to_video",
    "get_quick_vid_info",
    "vid2frames",
]
