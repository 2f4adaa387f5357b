r"""Prepare / process time split (``geotransformer_tpu/engine/timer.py``;
reference `utils/timer.py`).

Prepare time (waiting for the loader) is host wall time. Process time is
taken with CUDA events when the timer is given a CUDA device, so it is the
card's time between the two points rather than the time to enqueue the
work; the events are read (one synchronisation) only when a time is asked
for. Without a CUDA device both are host wall times.
"""

import time

import torch


class Timer:
    def __init__(self, device=None):
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.reset()

    def reset(self):
        self.total_prepare_time = 0.0
        self.count_prepare = 0
        self._process = []  # seconds, or (start, end) CUDA event pairs
        self._start = None
        self.last_time = time.perf_counter()

    def tic_prepare(self):
        self.last_time = time.perf_counter()

    def toc_prepare(self):
        self.total_prepare_time += time.perf_counter() - self.last_time
        self.count_prepare += 1

    def tic_process(self):
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()

    def toc_process(self):
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._process.append((self._start, end))
        else:
            self._process.append(time.perf_counter() - self._start)

    def process_times(self):
        """Seconds of every process interval so far."""
        if self.cuda and self._process:
            self._process[-1][1].synchronize()
        return [p if isinstance(p, float) else p[0].elapsed_time(p[1]) / 1e3
                for p in self._process]

    def get_prepare_time(self):
        return self.total_prepare_time / max(self.count_prepare, 1)

    def get_process_time(self):
        times = self.process_times()
        return sum(times) / max(len(times), 1)


class TimerDict:
    """Keyed host-clock timers (``geotransformer_tpu/engine/timer.py``;
    reference `utils/timer.py:48-79`): the mean seconds between each key's
    ``tic`` and ``toc``."""

    def __init__(self):
        self._starts = {}
        self._totals = {}
        self._counts = {}

    def tic(self, key):
        self._starts[key] = time.time()

    def toc(self, key):
        elapsed = time.time() - self._starts[key]
        self._totals[key] = self._totals.get(key, 0.0) + elapsed
        self._counts[key] = self._counts.get(key, 0) + 1

    def get_time(self, key):
        return self._totals.get(key, 0.0) / max(self._counts.get(key, 0), 1)

    def summary(self, keys=None):
        keys = keys if keys is not None else list(self._totals)
        return {k: self.get_time(k) for k in keys}
