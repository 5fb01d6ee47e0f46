"""Host-side schedules: sigma cadence, sigma factor table, scaling triggers.

A copy of `dots_socp_tpu/solver/schedule.py`: that module is jax-free, but
importing it runs `dots_socp_tpu/solver/__init__.py`, which imports jax.

Numerically identical to the reference's `AdjustAdmmParam`
(`utils/admm_tools.py:19-171`): same adjustment cadence (gaps 3/7/11/17/31/43
by iteration range), same primal/dual-gap -> factor lookup, same sigma
safeguard bounds [1e-3, 1e3], and the same scaling trigger predicates.
"""

from __future__ import annotations

import logging

import numpy as np

from dots_socp_tpu.config import LOG_LEVELS

# (iteration upper bound, required gap since last adjustment)
_ADJUST_CADENCE = ((20, 3), (50, 7), (100, 11), (200, 17), (500, 31))
_ADJUST_GAP_TAIL = 43

# (gap threshold, multiplicative factor), scanned top-down.
_GAP_FACTORS = (
    (50.0, 2.00),
    (35.0, 1.75),
    (20.0, 1.60),
    (10.0, 1.40),
    (5.0, 1.35),
    (3.0, 1.32),
    (2.5, 1.28),
    (2.0, 1.26),
    (1.5, 1.20),
    (1.2, 1.10),
)

SIGMA_UPPER = 1e3
SIGMA_LOWER = 1e-3


class SigmaSchedule:
    """Decides when and how to adjust the ALM penalty sigma (= r)."""

    def __init__(self):
        self.last_adjust_it = -1
        self.z_scale_count = 0

    def is_to_adjust(self, current_it: int) -> bool:
        """Adjustment cadence; densest early, sparser as iterations grow."""
        passed = current_it - self.last_adjust_it
        for bound, gap in _ADJUST_CADENCE:
            if current_it < bound:
                if passed >= gap:
                    self.last_adjust_it = current_it
                    return True
                return False
        if passed >= _ADJUST_GAP_TAIL:
            self.last_adjust_it = current_it
            return True
        return False

    def next_adjust_iteration(self, current_it: int) -> int:
        """First iteration >= current_it at which is_to_adjust would fire
        (pure; does not mutate the schedule state)."""
        it = current_it
        while True:
            passed = it - self.last_adjust_it
            gap = _ADJUST_GAP_TAIL
            for bound, g in _ADJUST_CADENCE:
                if it < bound:
                    gap = g
                    break
            if passed >= gap:
                return it
            it += 1

    @staticmethod
    def updated_sigma(sigma: float, prim_dual_gap: float) -> float:
        """New sigma from the gap lookup table, with safeguard bounds."""
        gap = prim_dual_gap
        invert = gap < 1.0
        if invert:
            gap = 1.0 / gap
        factor = 1.0
        for threshold, f in _GAP_FACTORS:
            if gap > threshold:
                factor = f
                break
        if invert:
            factor = 1.0 / factor
        return max(min(sigma * factor, SIGMA_UPPER), SIGMA_LOWER)

    @staticmethod
    def is_to_scale(current_it: int) -> bool:
        """Prim/dual rescale trigger (is_constant_scaling mode)."""
        return current_it == 10 or current_it == 50 or current_it % 100 == 50

    def is_to_scale_matrix(
        self,
        current_it: int,
        current_kkt,
        min_it: int = 100,
        max_scale_times: int = 1,
        tol: float = 5e-3,
    ) -> bool:
        """z-rescale trigger: fires at most max_scale_times, once past
        min_it iterations with all recorded KKT errors below tol."""
        kkt = np.asarray(current_kkt, dtype=float)
        if (
            current_it >= min_it
            and self.z_scale_count < max_scale_times
            and kkt.size > 0
            and np.nanmax(kkt) == np.nanmax(kkt)  # not all-NaN
            and np.max(kkt) < tol
        ):
            self.z_scale_count += 1
            return True
        return False

    @staticmethod
    def compute_scale_factor(prim_norm, dual_norm, msg="Norm of prim and dual"):
        """Rescale factors that bring the max primal/dual group norms to 1."""
        fmt = lambda v: "[" + ", ".join(f"{x:.2e}" for x in np.atleast_1d(v)) + "]"
        logging.log(
            LOG_LEVELS["scaling"],
            f"{msg}\nPrim Norm: {fmt(prim_norm)}\nDual Norm: {fmt(dual_norm)}",
        )
        return float(np.max(prim_norm)), float(np.max(dual_norm))


class AdaptiveKKTCadence:
    """Adaptive validation interval: check rarely while far from tolerance.

    Semantics of the reference's `AdaptiveValidatorWrapper`
    (`utils/condition_validator_wrapper.py:9-151`): interval 1 when at/below
    tolerance, max_interval when more than 10x away, log-linear in between;
    the per-iteration counter is reset around forced validations so the
    iteration right after a sigma adjustment is validated too.
    """

    def __init__(self, default_interval=1, min_interval=1, max_interval=37):
        self.default_interval = default_interval
        self.min_interval = min_interval
        self.max_interval = max_interval
        self.current_interval = default_interval
        self.counter = 0

    def set_error_and_tolerance(self, error: float, tolerance: float):
        if error is None or not np.isfinite(error):
            self.current_interval = self.max_interval
            return
        ratio = error / max(tolerance, 1e-10)
        if ratio <= 1.0:
            self.current_interval = self.min_interval
            return
        log_ratio = np.log10(ratio)
        if log_ratio > 1.0:
            self.current_interval = self.max_interval
        else:
            self.current_interval = max(
                self.min_interval,
                int(
                    self.min_interval
                    + log_ratio * (self.max_interval - self.min_interval)
                ),
            )

    def advance(self, n: int):
        """Advance the per-iteration counter by n skipped (non-validating)
        iterations dispatched inside a device chunk."""
        self.counter += n

    def tick(self, forced: bool) -> bool:
        """Advance one iteration; return whether to validate now."""
        if forced:
            self.counter = 0
        should = (self.counter % self.current_interval) == 0
        self.counter += 1
        if forced:
            self.counter = 0
            return True
        return should

    def iterations_until_next(self) -> int:
        """How many iterations from now until the cadence fires (>= 1)."""
        rem = self.counter % self.current_interval
        return 1 if rem == 0 else self.current_interval - rem + 1
