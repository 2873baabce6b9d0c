"""WebVid-style training data loader.

Host-side equivalent of the reference's LVDM training dataset
(lvdm webvid.py:14-188): CSV metadata (videoid, name/caption, page_dir),
video decoding with frame stride and fps-conditioned sampling, random or
center crop + resize, frames scaled to [-1, 1].

Differences from the reference (by design):
  * decord → cv2 (cv2 bundles FFmpeg), imported inside the functions that
    decode and resize, so the module imports on a host without it;
  * a background-thread prefetcher keeps the device fed — batches are
    assembled on host and shipped once per step (host↔device transfer is
    one contiguous array per batch);
  * deterministic per-epoch shuffling from a seed.

The port's own copy of the JAX package's ``data/webvid.py`` (pure host
code: numpy arrays out, no framework inside).
"""

from __future__ import annotations

import csv
import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class WebVidSample:
    frames: np.ndarray  # (F, H, W, 3) float32 in [-1, 1]
    caption: str
    video_path: str
    fps: float = 0.0  # clip fps after striding (reference webvid.py:176-179)
    frame_stride: int = 1


class WebVidDataset:
    def __init__(
        self,
        data_dir: str,
        meta_path: Optional[str] = None,
        *,
        video_length: int = 16,
        resolution: tuple[int, int] = (256, 256),
        frame_stride: int | list[int] = 1,
        crop: str = "random",  # "random" | "center"
        seed: int = 0,
        subsample: Optional[int] = None,
        fps_max: Optional[float] = None,
        fps_schedule: Optional[list[int]] = None,
        fs_probs: Optional[list[float]] = None,
        bs_per_device: Optional[int] = None,
        trigger_word: str = "",
    ):
        """fps-conditioning knobs (reference webvid.py:35-40,96-130):

        * ``frame_stride`` may be a LIST of candidate strides; each sample
          draws one — uniformly, by ``fs_probs`` weights, or staged by
          ``fps_schedule`` (global-step thresholds; needs
          ``bs_per_device`` to derive the step from the sample counter);
        * ``fps_max`` caps the reported clip fps;
        * ``trigger_word`` is appended to every caption (LoRA datasets).
        """
        self.data_dir = data_dir
        self.video_length = video_length
        self.resolution = resolution
        self.frame_stride = frame_stride
        self.crop = crop
        self.rng = np.random.default_rng(seed)
        self.fps_max = fps_max
        self.fps_schedule = fps_schedule
        self.fs_probs = fs_probs
        self.bs_per_device = bs_per_device
        self.trigger_word = trigger_word
        if fps_schedule is not None:
            if bs_per_device is None:
                raise ValueError("fps_schedule needs bs_per_device")
            if not isinstance(frame_stride, list) or len(frame_stride) != len(fps_schedule) + 1:
                raise ValueError(
                    "fps_schedule with N thresholds needs N+1 frame strides"
                )
        if fs_probs is not None and (
            not isinstance(frame_stride, list) or len(frame_stride) != len(fs_probs)
        ):
            raise ValueError("fs_probs must match the frame_stride list")
        self._counter = 0
        self._stage_idx = 0

        meta_path = meta_path or self._find_meta(data_dir)
        self.entries = self._read_meta(meta_path)
        if subsample:
            self.entries = self.entries[:subsample]

    def _pick_stride(self) -> int:
        """Per-sample frame stride (reference webvid.py:96-130)."""
        fs = self.frame_stride
        if not isinstance(fs, list):
            return int(fs)
        if self.fps_schedule is not None:
            import bisect

            global_step = self._counter // self.bs_per_device
            stage = bisect.bisect(self.fps_schedule, global_step)
            if stage != self._stage_idx:
                print(f"fps stage: {stage} start ... new frame stride = {fs[stage]}")
                self._stage_idx = stage
            return int(fs[stage])
        if self.fs_probs is not None:
            p = np.asarray(self.fs_probs, np.float64)
            return int(self.rng.choice(fs, p=p / p.sum()))
        return int(self.rng.choice(fs))

    @staticmethod
    def _find_meta(data_dir: str) -> str:
        for name in os.listdir(data_dir):
            if name.endswith(".csv"):
                return os.path.join(data_dir, name)
        raise FileNotFoundError(f"no metadata csv under {data_dir}")

    def _read_meta(self, meta_path: str) -> list[dict]:
        with open(meta_path, newline="") as f:
            return list(csv.DictReader(f))

    def __len__(self) -> int:
        return len(self.entries)

    def _video_path(self, entry: dict) -> str:
        page_dir = entry.get("page_dir", "")
        vid = entry.get("videoid") or entry.get("video_id") or entry.get("id")
        return os.path.join(self.data_dir, "videos", page_dir, f"{vid}.mp4")

    def _load_clip(self, path: str, stride: int) -> Optional[tuple[np.ndarray, float, int]]:
        import cv2

        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            return None
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps_ori = float(cap.get(cv2.CAP_PROP_FPS) or 0.0)
        if total < self.video_length:
            cap.release()
            return None
        if total < self.video_length * stride:
            # too short for the requested stride: recalc the max usable
            # stride (reference webvid.py:152-155)
            stride = max(1, total // self.video_length)
        need = self.video_length * stride
        start = int(self.rng.integers(0, total - need + 1))
        cap.set(cv2.CAP_PROP_POS_FRAMES, start)
        frames = []
        idx = 0
        while len(frames) < self.video_length:
            ok, frame = cap.read()
            if not ok:
                break
            if idx % stride == 0:
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            idx += 1
        cap.release()
        if len(frames) < self.video_length:
            return None
        # clip fps after striding, optionally capped (webvid.py:176-179)
        fps_clip = fps_ori // stride if stride else fps_ori
        if self.fps_max is not None and fps_clip > self.fps_max:
            fps_clip = self.fps_max
        return np.stack(frames), float(fps_clip), stride

    def _crop_resize(self, frames: np.ndarray) -> np.ndarray:
        import cv2

        f, h, w, _ = frames.shape
        th, tw = self.resolution
        scale = max(th / h, tw / w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        frames = np.stack(
            [cv2.resize(fr, (nw, nh), interpolation=cv2.INTER_AREA) for fr in frames]
        )
        if self.crop == "random":
            y0 = int(self.rng.integers(0, nh - th + 1))
            x0 = int(self.rng.integers(0, nw - tw + 1))
        else:
            y0, x0 = (nh - th) // 2, (nw - tw) // 2
        return frames[:, y0 : y0 + th, x0 : x0 + tw]

    def __getitem__(self, index: int) -> Optional[WebVidSample]:
        entry = self.entries[index]
        path = self._video_path(entry)
        loaded = self._load_clip(path, self._pick_stride())
        self._counter += 1  # fps_schedule progress (webvid.py:183-184)
        if loaded is None:
            return None
        clip, fps_clip, stride = loaded
        clip = self._crop_resize(clip)
        frames = clip.astype(np.float32) / 255.0 * 2.0 - 1.0
        caption = (entry.get("name") or entry.get("caption") or "") + self.trigger_word
        return WebVidSample(
            frames=frames, caption=caption, video_path=path,
            fps=fps_clip, frame_stride=stride,
        )

    def batches(
        self, batch_size: int, *, epochs: int = 1, prefetch: int = 2,
        with_fps: bool = False,
    ) -> Iterator[tuple]:
        """Yield (frames (B,F,H,W,3), captions[, fps (B,)]) with background
        prefetch. ``with_fps=True`` adds the per-clip fps array for
        fps-conditioned training (reference temporal_context cond,
        sample_utils.py:64-71)."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        DONE = object()

        def producer():
            # any failure must still unblock the consumer: ship the
            # exception through the queue instead of dying silently
            try:
                for _ in range(epochs):
                    order = self.rng.permutation(len(self.entries))
                    buf_frames, buf_caps, buf_fps = [], [], []
                    for i in order:
                        sample = self[int(i)]
                        if sample is None:
                            continue
                        buf_frames.append(sample.frames)
                        buf_caps.append(sample.caption)
                        buf_fps.append(sample.fps)
                        if len(buf_frames) == batch_size:
                            item = (np.stack(buf_frames), buf_caps)
                            if with_fps:
                                item += (np.asarray(buf_fps, np.float32),)
                            q.put(item)
                            buf_frames, buf_caps, buf_fps = [], [], []
            except BaseException as e:  # noqa: BLE001
                q.put(e)
            else:
                q.put(DONE)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
