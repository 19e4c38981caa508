"""The planner perf model: profile interpolation + SLA inversion.

A copy of dynamo_tpu/planner/perf_model.py: profiled (concurrency, ISL)
grid points (profiler/, a PerfProfile taken by either package) turned
into capacity answers under TTFT/ITL targets, with online correction
from live observations, on piecewise-linear interpolation:

    itl(active)                ITL estimate at a per-replica concurrency
    ttft(isl, active)          TTFT estimate
    max_active_for_itl(t)      largest per-replica concurrency with ITL<=t
    max_rps_for_ttft(isl, t)   best per-replica request rate with TTFT<=t

Online correction (`observe_itl`) is a clamped multiplicative EMA of
measured/predicted — the analogue of the reference's live FPM regression
warmup, so a stale profile converges instead of steering the fleet wrong
forever.
"""

from __future__ import annotations

import bisect
import logging
from typing import Dict, List, Optional, Sequence, Tuple

from ..profiler import PerfProfile

logger = logging.getLogger(__name__)


def _interp(xs: Sequence[float], ys: Sequence[float], x: float) -> float:
    """Piecewise-linear with linear extrapolation off both ends (capacity
    questions routinely land beyond the sweep grid)."""
    n = len(xs)
    if n == 0:
        return 0.0
    if n == 1:
        return ys[0]
    i = bisect.bisect_left(xs, x)
    i = max(1, min(n - 1, i))
    x0, x1 = xs[i - 1], xs[i]
    y0, y1 = ys[i - 1], ys[i]
    if x1 == x0:
        return y0
    return y0 + (y1 - y0) * (x - x0) / (x1 - x0)


class PerfModel:
    def __init__(self, profile: PerfProfile):
        self.profile = profile
        self.itl_correction = 1.0  # measured/predicted EMA, clamped
        self._corr_alpha = 0.2
        # KV storage dtype the profile was measured at (profiler stamps
        # meta["kv_cache_dtype"]; "" = untagged legacy profile).  An ITL
        # surface measured at bf16 applied to an int8 fleet (or vice
        # versa) is systematically wrong — int8 halves the decode read's
        # HBM bytes AND ~doubles the block pool, so both the latency
        # curve and the capacity answers shift.  check_kv_dtype warns
        # (once per offending dtype) instead of failing: the online ITL
        # correction still converges, but the operator should re-profile.
        self.kv_cache_dtype = str(profile.meta.get("kv_cache_dtype", ""))
        self._kv_dtype_warned: set = set()
        # group by isl: sorted (concurrency, itl_p95 / ttft_p95 / req_per_s)
        by_isl: Dict[int, List] = {}
        for p in profile.points:
            by_isl.setdefault(p.isl, []).append(p)
        self._isls = sorted(by_isl)
        self._curves: Dict[int, dict] = {}
        for isl, pts in by_isl.items():
            pts.sort(key=lambda p: p.concurrency)
            self._curves[isl] = {
                "c": [float(p.concurrency) for p in pts],
                # capacity planning and online correction both use MEAN
                # ITL: the live signal (worker itl_ema_s) is a mean, and
                # on burst-streaming engines (decode_fused_steps>1) the
                # p95 inter-token gap measures the burst period, ~k x the
                # true per-token rate — a throughput question wants the
                # mean.  p95 stays in the profile for reporting.
                "itl": [p.itl_mean_s for p in pts],
                "ttft": [p.ttft_p95_s for p in pts],
                "rps": [p.req_per_s for p in pts],
            }
        if not self._curves:
            raise ValueError("empty perf profile")

    @classmethod
    def load(cls, path: str) -> "PerfModel":
        return cls(PerfProfile.load(path))

    # -- estimation -------------------------------------------------------

    def _nearest_isl(self, isl: Optional[float]) -> int:
        if isl is None or not self._isls:
            return self._isls[len(self._isls) // 2]
        return min(self._isls, key=lambda g: abs(g - isl))

    def _isl_pair(self, isl: float) -> Tuple[int, int, float]:
        """Bracketing grid ISLs + blend weight for 2-D interpolation."""
        g = self._isls
        if isl <= g[0]:
            return g[0], g[0], 0.0
        if isl >= g[-1]:
            return g[-1], g[-1], 0.0
        i = bisect.bisect_left(g, isl)
        lo, hi = g[i - 1], g[i]
        return lo, hi, (isl - lo) / (hi - lo)

    def itl(self, active: float, isl: Optional[float] = None) -> float:
        """Mean-ITL estimate at per-replica concurrency `active`
        (corrected); comparable with the workers' live itl_ema_s."""
        cur = self._curves[self._nearest_isl(isl)]
        a = max(active, 1.0)
        raw = _interp(cur["c"], cur["itl"], a)
        if a >= cur["c"][-1]:
            # never extrapolate ITL *down* past the grid: a noisy
            # non-monotone tail (one bad p95 sample) would otherwise
            # predict zero latency at infinite concurrency
            raw = max(raw, cur["itl"][-1])
        return max(raw, 0.0) * self.itl_correction

    def ttft(self, isl: float, active: float = 1.0) -> float:
        lo, hi, w = self._isl_pair(isl)
        a = _interp(self._curves[lo]["c"], self._curves[lo]["ttft"],
                    max(active, 1.0))
        b = _interp(self._curves[hi]["c"], self._curves[hi]["ttft"],
                    max(active, 1.0))
        return max(a + (b - a) * w, 0.0)

    # -- SLA inversion ----------------------------------------------------

    def max_active_for_itl(self, target_s: float,
                           isl: Optional[float] = None) -> float:
        """Largest per-replica concurrency whose estimated ITL <= target.
        Floors at 0.5: an unattainable target over-provisions (replicas ~=
        2x active) instead of dividing by zero."""
        cur = self._curves[self._nearest_isl(isl)]
        cs = cur["c"]
        # walk the interpolated curve and stop at the FIRST violation:
        # prefix-feasibility is the conservative reading of non-monotone
        # samples (a noisy dip past a violated region is not capacity)
        lo, hi = 1.0, max(cs[-1] * 4.0, 2.0)
        best = 0.0
        steps = 128
        for k in range(steps + 1):
            c = lo + (hi - lo) * k / steps
            if self.itl(c, isl) > target_s:
                break
            best = c
        if best <= 0.0:
            logger.warning("perf model: ITL target %.4fs unattainable "
                           "even at concurrency 1", target_s)
            return 0.5
        return best

    def max_rps_for_ttft(self, isl: float, target_s: float) -> float:
        """Best per-replica sustainable request rate with TTFT <= target:
        max req_per_s over grid concurrencies whose TTFT estimate passes."""
        lo, hi, w = self._isl_pair(isl)
        # evaluate on the union of both bracketing concurrency grids
        cs = sorted(set(self._curves[lo]["c"]) | set(self._curves[hi]["c"]))
        best = 0.0
        for c in cs:
            if self.ttft(isl, c) <= target_s:
                a = _interp(self._curves[lo]["c"], self._curves[lo]["rps"], c)
                b = _interp(self._curves[hi]["c"], self._curves[hi]["rps"], c)
                best = max(best, a + (b - a) * w)
        if best <= 0.0:
            # even c=1 misses: capacity is c=1 throughput (best effort);
            # the SLO is unattainable at any replica count
            a = _interp(self._curves[lo]["c"], self._curves[lo]["rps"], 1.0)
            b = _interp(self._curves[hi]["c"], self._curves[hi]["rps"], 1.0)
            best = max(a + (b - a) * w, 1e-6)
            logger.warning("perf model: TTFT target %.4fs unattainable at "
                           "isl=%d; planning best-effort", target_s, isl)
        return best

    # -- profile fidelity -------------------------------------------------

    def check_kv_dtype(self, worker_dtypes) -> list:
        """Compare the live fleet's KV storage dtypes (worker load
        samples / MDC `kv_cache_dtype`) against the dtype this profile
        was measured at.  Returns the mismatching dtypes (empty = fine)
        and warns once per offending dtype.  Untagged values on either
        side are skipped — absence of evidence is not a mismatch."""
        if not self.kv_cache_dtype:
            return []
        bad = sorted({d for d in worker_dtypes
                      if d and d != self.kv_cache_dtype})
        for d in bad:
            if d not in self._kv_dtype_warned:
                self._kv_dtype_warned.add(d)
                logger.warning(
                    "perf model: profile was measured at "
                    "kv_cache_dtype=%s but live workers report %s — ITL/"
                    "TTFT estimates are systematically off; re-profile "
                    "at the serving dtype", self.kv_cache_dtype, d)
        return bad

    # -- online correction ------------------------------------------------

    def observe_itl(self, active: float, measured_s: float,
                    isl: Optional[float] = None) -> None:
        if measured_s <= 0 or active <= 0:
            return
        raw = self.itl(active, isl) / self.itl_correction
        if raw <= 0:
            return
        ratio = measured_s / raw
        ema = (1 - self._corr_alpha) * self.itl_correction \
            + self._corr_alpha * ratio
        self.itl_correction = min(4.0, max(0.25, ema))
