# The port's own copy of dots_socp_tpu/utils/history.py; only the import paths differ.
"""Running history: KKT records, step timers, progress bar, reports, plots.

Re-implementation of the reference's `RunningHistory`
(`utils/admm_tools.py:174-620`) with the same *output contract*: the
"Time of steps" / "Total Time" / "Total Iteration" / "The kkt errors at end" /
"Other history at end" log blocks are machine-parsed by the replication
table generator (`replication/log2table.py:98-106`), so labels and number
formats are preserved exactly. Timing on TPU wraps chunk dispatches with
block_until_ready at the call sites.
"""

from __future__ import annotations

import logging
import sys
import time
from contextlib import contextmanager
from math import log10
from typing import Any, List, Union

import numpy as np

from dots_socp_torch.config import LOG_LEVELS

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    tqdm = None


def _separator(text: str) -> str:
    return f"---- {text} ".ljust(42, "-")


class RunningHistory:
    """Records KKT errors over iterations/time and renders progress/reports."""

    def __init__(
        self,
        max_record_numbers: int,
        kkt_labels: List[str],
        name: str,
        kkt_short_labels: List[str] | None = None,
        use_linear_progress: bool = False,
    ):
        if kkt_short_labels is not None and len(kkt_short_labels) != len(kkt_labels):
            raise ValueError("kkt_short_labels must match kkt_labels in length")

        self.kkt_entry_num = len(kkt_labels)
        self.kkt_labels = kkt_labels
        self.kkt_short_labels = kkt_short_labels or kkt_labels
        self.name = name
        self.running_time = np.inf
        self.last_record_it = -1
        self.steps_time: dict = {}
        self.history: dict = {}

        self._max_num = max_record_numbers
        self._num = 0
        self._start_time = np.inf
        self._progress = None
        self._use_linear = use_linear_progress
        self._target_tol = None
        self._converged = set()

        self.kkt_errors = np.full((max_record_numbers, self.kkt_entry_num), np.inf)
        self.kkt_iteration = np.full(max_record_numbers, np.inf)
        self.kkt_time = np.full(max_record_numbers, np.inf)

        logging.basicConfig(level=LOG_LEVELS["info"], format="%(message)s")

    # ---- global timing -----------------------------------------------------
    def start(self):
        self._start_time = time.perf_counter()

    def end(self):
        self.running_time = time.perf_counter() - self._start_time
        self.kkt_errors = self.kkt_errors[: self._num]
        self.kkt_iteration = self.kkt_iteration[: self._num]
        self.kkt_time = self.kkt_time[: self._num]
        for key in self.history:
            self.history[key] = self.history[key][: self._num]
        if self._progress is not None:
            self._progress.close()
            print(_separator("Finish performing"))
            sys.stdout.flush()

    def get_running_time(self) -> float:
        return time.perf_counter() - self._start_time

    @contextmanager
    def timer(self, tag: str):
        t0 = time.perf_counter()
        yield
        self.steps_time[tag] = self.steps_time.get(tag, 0.0) + (
            time.perf_counter() - t0
        )

    def add_step_time(self, tag: str, seconds: float):
        """Accumulate step time measured externally (chunked TPU dispatch)."""
        self.steps_time[tag] = self.steps_time.get(tag, 0.0) + seconds

    # ---- recording ---------------------------------------------------------
    def record(
        self,
        current_it: int = None,
        kkt_errors: Union[List, np.ndarray] = None,
        history: dict[str, Any] = None,
    ):
        if kkt_errors is None or current_it is None:
            raise ValueError("record() requires current_it and kkt_errors")
        if current_it < self.last_record_it:
            raise ValueError(
                f"iteration {current_it} precedes last recorded "
                f"{self.last_record_it}"
            )
        if current_it == self.last_record_it:
            self._num -= 1  # overwrite in place
        if self._num >= self._max_num:
            raise ValueError("running-history buffer exhausted")

        self.last_record_it = current_it
        self.kkt_errors[self._num, :] = np.asarray(kkt_errors, dtype=float)
        self.kkt_iteration[self._num] = current_it
        self.kkt_time[self._num] = time.perf_counter() - self._start_time
        if history:
            for key, val in history.items():
                if key not in self.history:
                    self.history[key] = np.full_like(self.kkt_iteration, np.inf)
                self.history[key][self._num] = val
        self._num += 1

    def get_current_kkt_errors(self) -> np.ndarray:
        if self._num == 0:
            return np.full(self.kkt_entry_num, np.inf)
        return self.kkt_errors[self._num - 1, :]

    # ---- progress ----------------------------------------------------------
    def _tol_to_progress(self, tol: float) -> int:
        if self._use_linear:
            return round(1000.0 * log10(1.0 / tol))
        return round(1000.0 * (1.0 / tol) ** 0.5)

    def _new_progress_bar(self):
        if tqdm is None:
            return None
        return tqdm(
            total=self._tol_to_progress(self._target_tol),
            ncols=150,
            desc=f"Tol={self._target_tol:.2e}",
            bar_format="[{desc}{postfix}]|{bar}|{percentage:4.1f}%",
            leave=True,
        )

    def create_tol_progress(self, target_tol: float):
        print(_separator("Starting to perform ..."))
        self._target_tol = target_tol
        self._progress = self._new_progress_bar()
        logging.log(LOG_LEVELS["kkt"], _separator("Iteration Start"))

    def _format_condition_names(self, conditions) -> str:
        if not conditions:
            return "None"
        names = [
            self.kkt_short_labels[i] if isinstance(i, int) else str(i)
            for i in conditions
        ]
        if len(names) <= 2:
            return ", ".join(names)
        if len(names) <= 4:
            return ", ".join(names[:2]) + f" + {len(names) - 2} more"
        return f"{names[0]}, {names[1]} + {len(names) - 2} others"

    def show_tol_progress(
        self, current_it, current_err, active_idx=None, converged_idx=None
    ):
        if converged_idx:
            if self._progress is not None:
                names = self._format_condition_names(converged_idx)
                self._progress.set_postfix_str(f"Converged: {names}")
                self._progress.close()
                print(f"Conditions converged at iteration {current_it}: {names}\n")
            self._converged.update(
                i for i in converged_idx if isinstance(i, int)
            )
            if len(self._converged) < self.kkt_entry_num:
                self._progress = self._new_progress_bar()
            else:
                print("All KKT conditions have converged!")
                return

        if self._progress is None or current_err is None or not np.isfinite(
            current_err
        ):
            return
        self._progress.n = min(
            self._tol_to_progress(max(current_err, 1e-300)), self._progress.total
        )
        elapsed = time.perf_counter() - self._start_time
        fmt = "%H:%M:%S" if elapsed >= 3600 else "%M:%S"
        parts = [
            f"Acc: {current_err:.2e}",
            f"Time: {time.strftime(fmt, time.gmtime(elapsed))}",
            f"Iter: {current_it} ({elapsed / (current_it + 1):.4f} sec/it)",
        ]
        if active_idx is not None:
            parts.append(f"Checking: {self._format_condition_names(active_idx)}")
        self._progress.set_postfix_str(", ".join(parts))
        self._verbose_logging()

    def _verbose_logging(self):
        idx = self._num - 1
        if idx < 0:
            return
        msg_kkt = " ".join(f"{e:6.2e}" for e in self.kkt_errors[idx, :])
        logging.log(
            LOG_LEVELS["kkt"],
            f"Iteration: {self.kkt_iteration[idx]:4.0f} - KKT: {msg_kkt}",
        )

    # ---- reports -----------------------------------------------------------
    def show_kkt_errors(
        self,
        filename: str = None,
        is_show_when_save: bool = False,
        x_axis: str = "iteration",
        title: str = None,
        x_label: str = None,
        y_label: str = None,
    ):
        """Semilogy KKT curves vs iteration or wall time; show and/or save."""
        from matplotlib import pyplot as plt

        if x_axis == "iteration":
            x_data, x_default = self.kkt_iteration, "Iteration numbers"
        elif x_axis == "time":
            x_data, x_default = self.kkt_time, "Iteration time [seconds]"
        else:
            raise ValueError(f"x_axis {x_axis!r} not supported")

        fig = plt.figure()
        for n in range(self.kkt_entry_num):
            errs = self.kkt_errors[:, n].copy()
            errs[errs < 1e-10] = 0.0
            plt.semilogy(x_data, errs, label=self.kkt_short_labels[n])
        plt.title(title if isinstance(title, str) else self.name)
        plt.xlabel(x_label if isinstance(x_label, str) else x_default)
        plt.ylabel(
            y_label if isinstance(y_label, str) else "Karush–Kuhn–Tucker errors"
        )
        plt.legend()

        if isinstance(filename, str):
            if is_show_when_save:
                fig.show()
            fig.savefig(filename, bbox_inches="tight")
        else:
            fig.show()
        plt.close(fig)

    def print_steps_time(
        self,
        tag_tips: str = "Time of each step",
        tag_step_time: str = "Time of steps",
        tag_total_time: str = "Total Time",
        tag_total_iteration: str = "Total Iteration",
    ):
        total_time = self.running_time
        total_it = self.kkt_iteration[-1] if self._num else 0
        labels = list(self.steps_time.keys())
        times = list(self.steps_time.values())
        sum_steps = sum(times)
        width = max(
            len(s) for s in labels + [tag_step_time, tag_total_time, tag_total_iteration]
        )
        per100 = lambda t: 100.0 * t / max(total_it, 1)
        lines = [
            f"{label:<{width}}: {t:>7.2f} sec ({100.0 * t / total_time:5.2f}%) "
            f"({per100(t):<5.2f} sec/100-iterations)"
            for label, t in zip(labels, times)
        ]
        summary = (
            f"{tag_step_time.ljust(width)}: {sum_steps:>7.2f} sec "
            f"({100.0 * sum_steps / total_time:5.2f}%) "
            f"({per100(sum_steps):<5.2f} sec/100-iterations)\n"
            f"{tag_total_time.ljust(width)}: {total_time:>7.2f} sec (100.00%)\n"
            f"{tag_total_iteration.ljust(width)}: {total_it:>7.0f} iterations"
        )
        logging.log(
            LOG_LEVELS["info"],
            f"{_separator(tag_tips)}\n"
            + "\n".join(lines)
            + ("\n" if lines else "")
            + "-" * 42
            + f"\n{summary}",
        )

    def print_end_history(self):
        errs = self.kkt_errors[-1, :] if self._num else np.full(self.kkt_entry_num, np.inf)
        width = max(len(label) for label in self.kkt_labels)
        msg = "\n".join(
            f"{label:<{width}}: {err:>6.2e}"
            for err, label in zip(errs, self.kkt_labels)
        )
        logging.log(
            LOG_LEVELS["info"], f"{_separator('The kkt errors at end')}\n{msg}"
        )
        if self.history:
            msg_hist = "\n".join(
                f"{key}: {vals[-1]:.6e}" for key, vals in self.history.items()
            )
            logging.log(
                LOG_LEVELS["info"],
                f"{_separator('Other history at end')}\n{msg_hist}",
            )
