"""Host-side video IO: frame extraction, stitching, soundtrack, metadata.

Covers the reference's video_audio_utils.py surface:
  * ``vid2frames``          — frame extraction with range / nth-frame
                              (video_audio_utils.py:18-79, cv2-based)
  * ``ffmpeg_stitch_video`` — png-seq → h264 with crf/preset, soundtrack
                              mux, MP4 comment metadata (:126-212)
  * ``find_ffmpeg_binary``  — binary discovery (:109-123); this build also
                              falls back to cv2.VideoWriter when no ffmpeg
                              binary exists (no soundtrack/metadata then —
                              reported, not silently dropped)
  * ``get_quick_vid_info``  — fps/frame-count/resolution probe (:215-225)

All of this is deliberately host-side Python — codecs and muxing are not
accelerator work. The port's copy of the JAX package's ``media/video.py``:
``cv2`` is imported inside the functions that use it, so the module imports
on a host without OpenCV (the GPU host is not known to have it).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Iterable, Optional

import numpy as np


def find_ffmpeg_binary() -> Optional[str]:
    """Locate an ffmpeg binary (imageio-ffmpeg wheel, PATH, or None)."""
    try:
        import imageio_ffmpeg

        return imageio_ffmpeg.get_ffmpeg_exe()
    except ImportError:
        pass
    return shutil.which("ffmpeg")


VIDEO_FILE_FORMATS = ("mov", "mpeg", "mp4", "m4v", "avi", "mpg", "webm")


def is_url(path: str) -> bool:
    return path.startswith("http://") or path.startswith("https://")


def validate_video_path(video_path: str) -> bool:
    """Input validation for vid2vid sources — local paths AND URLs
    (video_audio_utils.py:81-101): extension whitelist, existence check for
    files, reachability (HEAD) for URLs. Raises on failure, returns True."""
    extension = video_path.rsplit(".", 1)[-1].lower()
    # strip querystrings from URL extensions before checking
    extension = extension.split("?", 1)[0].split("#", 1)[0]
    if is_url(video_path):
        import urllib.request

        req = urllib.request.Request(video_path, method="HEAD")
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                status = getattr(resp, "status", 200)
        except Exception as e:
            raise ConnectionError(f"Video URL is not valid: {e}") from e
        if status != 200:
            raise ConnectionError(
                f"Video URL is not valid. Response status code: {status}"
            )
        if extension not in VIDEO_FILE_FORMATS:
            raise ValueError(
                f"Video file format '{extension}' not supported. "
                f"Supported formats are: {list(VIDEO_FILE_FORMATS)}"
            )
    else:
        if not os.path.exists(video_path):
            raise RuntimeError("Video path does not exist.")
        if extension not in VIDEO_FILE_FORMATS:
            raise ValueError(
                f"Video file format '{extension}' not supported. "
                f"Supported formats are: {list(VIDEO_FILE_FORMATS)}"
            )
    return True


def _download_video(url: str) -> str:
    """Fetch a remote video to a temp file (the reference streams URLs
    straight into cv2, which needs an ffmpeg-enabled build; downloading
    first is robust either way)."""
    import tempfile
    import urllib.request

    suffix = "." + url.rsplit(".", 1)[-1].split("?", 1)[0].split("#", 1)[0]
    fd, tmp = tempfile.mkstemp(prefix="t2v_vid2vid_", suffix=suffix)
    os.close(fd)
    urllib.request.urlretrieve(url, tmp)
    return tmp


def clean_folder_name(string: str) -> str:
    """Sanitise a string for folder use (video_audio_utils.py:104-107)."""
    illegal_chars = "/\\<>:\"|?*.,\" "
    return string.translate(str.maketrans(illegal_chars, "_" * len(illegal_chars)))


def duplicate_pngs_from_folder(
    from_folder: str, to_folder: str, img_batch_id: Optional[str], orig_vid_name: Optional[str]
) -> int:
    """Copy/re-encode a folder's PNG/JPG frames into ``from_folder/to_folder``
    (video_audio_utils.py:234-252: re-encode normalises bit depth unless the
    source was a video run). Returns the number of frames handled."""
    import cv2

    dest = os.path.join(from_folder, to_folder)
    os.makedirs(dest, exist_ok=True)
    handled = 0
    for f in sorted(os.listdir(from_folder)):
        if not (("png" in f or "jpg" in f) and "-" not in f and "_depth_" not in f):
            continue
        if img_batch_id is not None and not f.startswith(img_batch_id):
            continue
        src = os.path.join(from_folder, f)
        handled += 1
        if orig_vid_name is not None:
            shutil.copy(src, dest)
        else:
            img = cv2.imread(src)
            cv2.imwrite(os.path.join(dest, f), img, [cv2.IMWRITE_PNG_COMPRESSION, 0])
    return handled


def vid2frames(
    video_path: str,
    out_dir: Optional[str] = None,
    *,
    n: int = 1,
    start_frame: int = 0,
    end_frame: int = -1,
    numeric_files_output: bool = True,
) -> list[np.ndarray]:
    """Extract frames [start_frame, end_frame) taking every n-th frame.

    Accepts local paths or http(s) URLs (validated + fetched per
    video_audio_utils.py:81-101). Returns RGB uint8 arrays; also writes
    PNGs when out_dir is given.
    """
    import cv2

    tmp_download = None
    if is_url(video_path):
        validate_video_path(video_path)
        cap = cv2.VideoCapture(video_path)
        if not cap.isOpened():  # cv2 build without URL support
            tmp_download = _download_video(video_path)
            video_path = tmp_download
            cap = cv2.VideoCapture(video_path)
    else:
        cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        if tmp_download:
            os.remove(tmp_download)
        raise ValueError(f"cannot open video {video_path}")
    frames = []
    idx = 0
    written = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if idx >= start_frame and (end_frame < 0 or idx < end_frame):
            if (idx - start_frame) % n == 0:
                rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                frames.append(rgb)
                if out_dir is not None:
                    os.makedirs(out_dir, exist_ok=True)
                    name = f"{written:09d}.png" if numeric_files_output else f"frame{written}.png"
                    cv2.imwrite(os.path.join(out_dir, name), frame)
                written += 1
        idx += 1
        if end_frame >= 0 and idx >= end_frame:
            break
    cap.release()
    if tmp_download:
        os.remove(tmp_download)
    return frames


def get_quick_vid_info(video_path: str) -> tuple[float, int, tuple[int, int]]:
    """(fps, frame_count, (width, height))."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise ValueError(f"cannot open video {video_path}")
    fps = cap.get(cv2.CAP_PROP_FPS)
    count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    size = (
        int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
    )
    cap.release()
    return fps, count, size


def _cv2_stitch(frames: Iterable[np.ndarray], out_path: str, fps: float) -> None:
    import cv2

    frames = list(frames)
    h, w = frames[0].shape[:2]
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writer = cv2.VideoWriter(out_path, fourcc, fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter could not open {out_path}")
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()


def ffmpeg_stitch_video(
    *,
    frames: Optional[list[np.ndarray]] = None,
    imgs_path: Optional[str] = None,
    out_path: str,
    fps: float = 15,
    crf: int = 17,
    preset: str = "slow",
    metadata_comment: Optional[str] = None,
    add_soundtrack: str = "None",
    audio_path: Optional[str] = None,
    ffmpeg_location: Optional[str] = None,
) -> str:
    """Stitch frames (RGB arrays or a %09d.png sequence dir) into an mp4.

    With an ffmpeg binary: h264 with crf/preset, optional soundtrack mux and
    an MP4 comment metadata atom carrying the infotext
    (video_audio_utils.py:126-212). Without one: cv2 mp4v fallback (and a
    printed notice about dropped soundtrack/metadata).
    """
    import cv2

    ffmpeg = ffmpeg_location or find_ffmpeg_binary()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)

    if ffmpeg is None:
        if frames is None:
            frames = _read_png_sequence(imgs_path)
        _cv2_stitch(frames, out_path, fps)
        if add_soundtrack != "None" or metadata_comment:
            print(
                "t2v.media: no ffmpeg binary found — wrote cv2 mp4v video "
                "without soundtrack/metadata"
            )
        return out_path

    tmp_imgs_dir = None
    if imgs_path is None:
        assert frames is not None
        import tempfile

        imgs_path = tmp_imgs_dir = tempfile.mkdtemp(prefix="t2v_frames_")
        for i, f in enumerate(frames):
            cv2.imwrite(os.path.join(imgs_path, f"{i:09d}.png"), cv2.cvtColor(f, cv2.COLOR_RGB2BGR))

    cmd = [
        ffmpeg, "-y", "-vcodec", "png",
        "-r", str(fps),
        "-start_number", "0",
        "-i", os.path.join(imgs_path, "%09d.png"),
        "-frames:v", "100000",
        "-c:v", "libx264",
        "-vf", f"fps={fps}",
        "-pix_fmt", "yuv420p",
        "-crf", str(crf),
        "-preset", preset,
    ]
    if metadata_comment:
        cmd += ["-metadata", f"comment={metadata_comment}"]
    cmd += [out_path]
    try:
        subprocess.run(cmd, check=True, capture_output=True)

        if add_soundtrack != "None" and audio_path:
            tmp = out_path + ".audio.mp4"
            mux = [
                ffmpeg, "-y", "-i", out_path, "-i", audio_path,
                "-c:v", "copy", "-c:a", "aac", "-shortest", tmp,
            ]
            subprocess.run(mux, check=True, capture_output=True)
            os.replace(tmp, out_path)
    finally:
        if tmp_imgs_dir is not None:
            import shutil

            shutil.rmtree(tmp_imgs_dir, ignore_errors=True)
    return out_path


def _read_png_sequence(imgs_path: str) -> list[np.ndarray]:
    import cv2

    names = sorted(n for n in os.listdir(imgs_path) if n.endswith(".png"))
    return [
        cv2.cvtColor(cv2.imread(os.path.join(imgs_path, n)), cv2.COLOR_BGR2RGB)
        for n in names
    ]


def frames_to_video(frames: list[np.ndarray], out_path: str, fps: float = 15, **kw) -> str:
    return ffmpeg_stitch_video(frames=frames, out_path=out_path, fps=fps, **kw)


def save_gif(frames: list[np.ndarray], out_path: str, fps: float = 15) -> str:
    """Animated GIF writer (the reference's ``make_gif`` output arg,
    args.py:266 — carried but never implemented there)."""
    from PIL import Image

    ims = [Image.fromarray(np.asarray(f, np.uint8)) for f in frames]
    ims[0].save(
        out_path,
        save_all=True,
        append_images=ims[1:],
        duration=max(1, int(round(1000.0 / max(fps, 1e-6)))),
        loop=0,
    )
    return out_path


def video_to_data_url(path: str) -> str:
    """base64 data-URL packing (process_modelscope.py:257-266 role)."""
    import base64

    with open(path, "rb") as f:
        data = base64.b64encode(f.read()).decode()
    return f"data:video/mp4;base64,{data}"


def make_video_grid(videos: list[np.ndarray], nrow: int | None = None, pad: int = 2) -> list[np.ndarray]:
    """Tile n same-shaped videos (each (F, H, W, 3) uint8) into one grid
    video — the reference's torchvision ``make_grid``-per-frame step inside
    ``npz_to_video_grid`` (lvdm saving_utils.py:36-71). Returns grid frames."""
    n = len(videos)
    if n == 0:
        raise ValueError("no videos to grid")
    f, h, w, c = videos[0].shape
    for v in videos:
        if v.shape != (f, h, w, c):
            raise ValueError("grid requires same-shaped videos")
    ncol = nrow or int(np.ceil(np.sqrt(n)))
    nrows = int(np.ceil(n / ncol))
    frames = []
    for t in range(f):
        canvas = np.zeros(
            (nrows * (h + pad) + pad, ncol * (w + pad) + pad, c), np.uint8
        )
        for i, v in enumerate(videos):
            r, col = divmod(i, ncol)
            y = pad + r * (h + pad)
            x = pad + col * (w + pad)
            canvas[y : y + h, x : x + w] = v[t]
        frames.append(canvas)
    return frames


def save_video_grid(
    videos: list[np.ndarray],
    out_path: str,
    fps: float = 8,
    nrow: int | None = None,
    **kw,
) -> str:
    """n videos → one grid mp4 (``npz_to_video_grid`` role, used by the
    VideoCrafter batch output path, process_videocrafter.py:84-93)."""
    return ffmpeg_stitch_video(
        frames=make_video_grid(videos, nrow=nrow), out_path=out_path, fps=fps, **kw
    )


# ---------------------------------------------------------------------------
# MP4 metadata reading (the reference UI's "Metadata viewer" reads the
# ©cmt atom with mutagen.MP4, args.py:170-175; this is a dependency-free
# ISO-BMFF box walk: moov → udta → meta → ilst → ©cmt → data)


def _iter_boxes(buf: bytes, start: int, end: int):
    """Yield (box_type, payload_start, payload_end) for boxes in [start, end)."""
    pos = start
    while pos + 8 <= end:
        size = int.from_bytes(buf[pos : pos + 4], "big")
        btype = buf[pos + 4 : pos + 8]
        hdr = 8
        if size == 1:  # 64-bit extended size
            if pos + 16 > end:
                return
            size = int.from_bytes(buf[pos + 8 : pos + 16], "big")
            hdr = 16
        elif size == 0:  # box extends to end of file
            size = end - pos
        if size < hdr or pos + size > end:
            return
        yield btype, pos + hdr, pos + size
        pos += size


def _find_box(buf: bytes, start: int, end: int, btype: bytes, fullbox: bool = False):
    for t, s, e in _iter_boxes(buf, start, end):
        if t == btype:
            return (s + 4, e) if fullbox else (s, e)  # fullbox: skip ver/flags
    return None


def read_mp4_metadata_comment(path: str) -> Optional[str]:
    """Return the MP4 comment (©cmt) metadata string, or None.

    Reads back what ``ffmpeg_stitch_video`` writes via ``-metadata
    comment=`` (the infotext provenance atom, reference
    video_audio_utils.py:206-210).
    """
    # stream over the top-level boxes and load only `moov` (metadata-only,
    # typically KBs) — never the media payload (`mdat` can be GBs)
    import struct

    moov_cap = 64 * 1024 * 1024
    buf = None
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos + 8 <= size:
            f.seek(pos)
            header = f.read(8)
            if len(header) < 8:
                break
            box_size = struct.unpack(">I", header[:4])[0]
            btype = header[4:8]
            hdr_len = 8
            if box_size == 1:  # 64-bit largesize
                ext = f.read(8)
                if len(ext) < 8:
                    break
                box_size = struct.unpack(">Q", ext)[0]
                hdr_len = 16
            elif box_size == 0:  # box extends to EOF
                box_size = size - pos
            if box_size < hdr_len:
                break
            if btype == b"moov":
                n = min(box_size - hdr_len, moov_cap)
                buf = f.read(n)
                break
            pos += box_size
    if buf is None:
        return None
    span = (0, len(buf))
    for btype, fullbox in (
        (b"udta", False), (b"meta", True), (b"ilst", False),
        (b"\xa9cmt", False), (b"data", False),
    ):
        span = _find_box(buf, span[0], span[1], btype, fullbox)
        if span is None:
            return None
    s, e = span
    # data atom payload: 4-byte type indicator + 4-byte locale, then text
    if e - s < 8:
        return None
    return buf[s + 8 : e].decode("utf-8", errors="replace")


def save_image_sheet(
    frames: list[np.ndarray], out_path: str, ncol: int | None = None
) -> str:
    """Save frames as one contact-sheet PNG (reference ``savenp2sheet``,
    lvdm saving_utils.py:36-65: row-major hconcat/vconcat grid). Frames
    are RGB uint8 (H, W, 3); written via cv2 as BGR."""
    import cv2

    n = len(frames)
    if n == 0:
        raise ValueError("no frames to sheet")
    ncol = ncol or min(n, 8)
    nrow = (n + ncol - 1) // ncol
    h, w = frames[0].shape[:2]
    sheet = np.zeros((nrow * h, ncol * w, 3), np.uint8)
    for i, f in enumerate(frames):
        r, c = divmod(i, ncol)
        sheet[r * h : (r + 1) * h, c * w : (c + 1) * w] = f
    cv2.imwrite(out_path, cv2.cvtColor(sheet, cv2.COLOR_RGB2BGR))
    return out_path
