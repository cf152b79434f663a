"""Wall-clock timing (counterpart of src/utils/timer.{h,cpp}; a copy of
``mcmc_colorer_tpu/utils/timer.py``)."""

from __future__ import annotations

import time


class Timer:
    """start/stop stopwatch reporting milliseconds, like the reference's
    chrono-based Timer (timer.cpp:7-19)."""

    def __init__(self) -> None:
        self._t0: float | None = None
        self._t1: float | None = None

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        self._t1 = None
        return self

    def stop(self) -> float:
        self._t1 = time.perf_counter()
        return self.duration_ms

    @property
    def duration_ms(self) -> float:
        if self._t0 is None:
            return 0.0
        end = self._t1 if self._t1 is not None else time.perf_counter()
        return (end - self._t0) * 1e3

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
