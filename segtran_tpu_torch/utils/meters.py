"""Running-average meters (counterpart of ``segtran_tpu/utils/meters.py``;
reference code/common_util.py:23-60): a total and a windowed 'disp'
average per key, with a NaN trap."""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict


class AverageMeters:
    def __init__(self):
        self.total_sum: Dict[str, float] = defaultdict(float)
        self.total_count: Dict[str, int] = defaultdict(int)
        self.disp_sum: Dict[str, float] = defaultdict(float)
        self.disp_count: Dict[str, int] = defaultdict(int)

    def update(self, key: str, value: float, n: int = 1):
        value = float(value)
        if math.isnan(value):
            raise FloatingPointError(f"NaN in metric '{key}'")
        self.total_sum[key] += value * n
        self.total_count[key] += n
        self.disp_sum[key] += value * n
        self.disp_count[key] += n

    def avg(self, key: str) -> float:
        c = self.total_count[key]
        return self.total_sum[key] / c if c else 0.0

    def disp_avg(self, key: str) -> float:
        c = self.disp_count[key]
        return self.disp_sum[key] / c if c else 0.0

    def reset_disp(self):
        self.disp_sum.clear()
        self.disp_count.clear()

    def disp_str(self, keys=None) -> str:
        keys = keys or sorted(self.disp_count)
        return ", ".join(f"{k}: {self.disp_avg(k):.4f}" for k in keys)
