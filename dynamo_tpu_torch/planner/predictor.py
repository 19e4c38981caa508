"""PREDICT: next-window load forecasting.

A copy of dynamo_tpu/planner/predictor.py: three forecasters a serving
control loop can afford on the host:

    constant — last observation (the reference's default)
    ema      — exponential moving average (noise-robust)
    linear   — least-squares trend over the window, extrapolated one step
               (catches ramps before they saturate the fleet)
"""

from __future__ import annotations

from collections import deque
from typing import Deque


class ConstantPredictor:
    name = "constant"

    def __init__(self, window: int = 8):
        self._last = 0.0

    def observe(self, value: float) -> None:
        self._last = value

    def predict(self) -> float:
        return self._last


class EmaPredictor:
    name = "ema"

    def __init__(self, window: int = 8):
        self.alpha = 2.0 / (window + 1)
        self._ema: float | None = None

    def observe(self, value: float) -> None:
        self._ema = value if self._ema is None else (
            self.alpha * value + (1 - self.alpha) * self._ema
        )

    def predict(self) -> float:
        return self._ema or 0.0


class LinearPredictor:
    name = "linear"

    def __init__(self, window: int = 8):
        self.window = window
        self._obs: Deque[float] = deque(maxlen=window)

    def observe(self, value: float) -> None:
        self._obs.append(value)

    def predict(self) -> float:
        n = len(self._obs)
        if n == 0:
            return 0.0
        if n == 1:
            return self._obs[0]
        xs = range(n)
        mean_x = (n - 1) / 2.0
        mean_y = sum(self._obs) / n
        num = sum((x - mean_x) * (y - mean_y)
                  for x, y in zip(xs, self._obs))
        den = sum((x - mean_x) ** 2 for x in xs)
        slope = num / den if den else 0.0
        return max(0.0, mean_y + slope * (n - mean_x))  # one step ahead


_PREDICTORS = {p.name: p for p in
               (ConstantPredictor, EmaPredictor, LinearPredictor)}


def make_predictor(name: str, window: int = 8):
    try:
        return _PREDICTORS[name](window=window)
    except KeyError:
        raise ValueError(
            f"unknown predictor {name!r}; have {sorted(_PREDICTORS)}"
        ) from None
