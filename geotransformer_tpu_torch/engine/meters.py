r"""Running statistics: the port's copy of ``geotransformer_tpu/engine/meters.py``
(reference `utils/average_meter.py`, `utils/summary_board.py`)."""

from collections import defaultdict

import numpy as np


class AverageMeter:
    """Running mean/std/min/max over scalar records, with optional last-n window."""

    def __init__(self, last_n=None):
        self._records = []
        self.last_n = last_n

    def update(self, result):
        if isinstance(result, (list, tuple)):
            self._records.extend(result)
        else:
            self._records.append(result)

    def reset(self):
        self._records.clear()

    @property
    def records(self):
        if self.last_n is not None:
            return self._records[-self.last_n:]
        return self._records

    def sum(self):
        return float(np.sum(self.records)) if self.records else 0.0

    def mean(self):
        return float(np.mean(self.records)) if self.records else 0.0

    def std(self):
        return float(np.std(self.records)) if self.records else 0.0

    def median(self):
        return float(np.median(self.records)) if self.records else 0.0

    def min(self):
        return float(np.min(self.records)) if self.records else 0.0

    def max(self):
        return float(np.max(self.records)) if self.records else 0.0


class SummaryBoard:
    """Keyed collection of AverageMeters (reference utils/summary_board.py:7-93)."""

    def __init__(self, names=None, last_n=None, adaptive=True):
        self.meters = {}
        self.last_n = last_n
        self.adaptive = adaptive
        for name in names or []:
            self.register_meter(name)

    def register_meter(self, name):
        self.meters[name] = AverageMeter(last_n=self.last_n)

    def update(self, name, value):
        if name not in self.meters:
            if not self.adaptive:
                raise KeyError(name)
            self.register_meter(name)
        self.meters[name].update(value)

    def update_from_dict(self, result_dict):
        for name, value in result_dict.items():
            self.update(name, float(value))

    def reset_all(self):
        for meter in self.meters.values():
            meter.reset()

    def mean(self, name):
        return self.meters[name].mean()

    def summary(self, names=None):
        names = names if names is not None else list(self.meters)
        return {name: self.meters[name].mean() for name in names}

    def tostring(self, names=None):
        return ", ".join(f"{k}: {v:.4f}" for k, v in self.summary(names).items())
