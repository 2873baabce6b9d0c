"""Cooperative job state — interrupt / skip / progress.

The port's copy of the JAX package's ``core/state.py``: the web UI or API
sets ``interrupted``/``skipped`` and the sampling loop's callback
(``step_callback``) raises between steps, which stops the request.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field


class InterruptedException(BaseException):
    pass


class SkippedException(BaseException):
    pass


@dataclass
class JobState:
    interrupted: bool = False
    skipped: bool = False
    sampling_step: int = 0
    sampling_steps: int = 0
    job_no: int = 0
    job_count: int = 0
    job: str = ""
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def interrupt(self):
        with self._lock:
            self.interrupted = True

    def skip(self):
        with self._lock:
            self.skipped = True

    def begin_job(self, job_no: int, job_count: int, steps: int):
        with self._lock:
            self.job_no = job_no
            self.job_count = job_count
            self.job = f"Batch {job_no + 1} out of {job_count}"
            self.sampling_step = 0
            self.sampling_steps = steps
            self.skipped = False

    def step_callback(self, step: int):
        """Sampler chunk callback: record progress, raise on cancel."""
        with self._lock:
            self.sampling_step = step
            if self.interrupted:
                raise InterruptedException
            if self.skipped:
                raise SkippedException

    def reset(self):
        with self._lock:
            self.interrupted = False
            self.skipped = False
            self.sampling_step = 0
            self.job_no = 0


# module-level default state (the api/cli share it like A1111's shared.state)
state = JobState()
