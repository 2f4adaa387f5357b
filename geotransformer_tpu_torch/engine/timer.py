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

