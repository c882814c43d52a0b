"""Windowed/running meters (reference ``util/misc.py:41-166`` SmoothedValue /
MetricLogger and ``utils/AverageMeter.py``).

Own copy of ``gm3d_tpu/utils/meters.py`` (plain Python). The meters take
Python floats: the caller reads device values to the host first."""

from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Dict, Iterable


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg, value=self.value
        )


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def global_avgs(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for i, obj in enumerate(iterable):
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            end = time.time()
            if i % print_freq == 0:
                print(
                    f"{header} [{i}]  {self}  time: {iter_time}  data: {data_time}",
                    flush=True,
                )


class AverageMeter:
    """Multi-item running averages (``utils/AverageMeter.py:2-42``)."""

    def __init__(self, items=None):
        self.items = items
        self.n = 1 if items is None else len(items)
        self.reset()

    def reset(self):
        self._val = [0.0] * self.n
        self._sum = [0.0] * self.n
        self._count = [0] * self.n

    def update(self, values):
        if not isinstance(values, (list, tuple)):
            values = [values]
        for i, v in enumerate(values):
            self._val[i] = float(v)
            self._sum[i] += float(v)
            self._count[i] += 1

    def avg(self, idx=None):
        if idx is None:
            avgs = [s / c if c else 0.0 for s, c in zip(self._sum, self._count)]
            return avgs if self.n > 1 else avgs[0]
        return self._sum[idx] / self._count[idx] if self._count[idx] else 0.0
