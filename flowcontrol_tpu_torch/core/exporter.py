"""Timeseries log of a run (in memory, written as CSV on request).

The counterpart of ``flowcontrol_tpu/core/exporter.py`` (ref:
src/flowcontrol/exporter.py), reduced to its timeseries: one row per logged
step, with the same columns in the same order as the reference's
DataFrame (first appearance: time, dE, runtime, y_meas_*, then u_ctrl_*),
written with the ``csv`` module so the run needs no pandas. HDF5 field
snapshots, Paraview indexes and the restart sidecar are not ported yet
(ROADMAP.md); :class:`FlowSolver` refuses ``save_every > 0`` for that reason.
"""

from __future__ import annotations

import csv
import logging
import math

import numpy as np

from flowcontrol_tpu_torch.core.flowfield import SimPaths

logger = logging.getLogger(__name__)


class FlowExporter:
    """In-memory timeseries with CSV output and progress logging."""

    def __init__(self, paths: SimPaths) -> None:
        self.paths = paths
        self._records: list[dict] = []

    def log_ic(self, t: float, y_meas, dE: float) -> None:
        row = {"time": t, "dE": float(dE), "runtime": 0.0}
        for i, v in enumerate(np.atleast_1d(y_meas)):
            row[f"y_meas_{i + 1}"] = float(v)
        self._records.append(row)

    def log(self, u_ctrl, y_meas, dE, t, runtime) -> None:
        row = {"time": float(t), "dE": float(dE), "runtime": float(runtime)}
        for i, v in enumerate(np.atleast_1d(u_ctrl)):
            row[f"u_ctrl_{i + 1}"] = float(v)
        for i, v in enumerate(np.atleast_1d(y_meas)):
            row[f"y_meas_{i + 1}"] = float(v)
        self._records.append(row)

    def columns(self) -> list[str]:
        """Column names in order of first appearance (the DataFrame order)."""
        cols: dict[str, None] = {}
        for r in self._records:
            cols.update(dict.fromkeys(r))
        return list(cols)

    def to_columns(self) -> dict[str, np.ndarray]:
        """{column: values}, NaN where a row lacks the column."""
        return {
            c: np.array([r.get(c, np.nan) for r in self._records], dtype=float)
            for c in self.columns()
        }

    def write_timeseries(self) -> None:
        """CSV as pandas writes it: header row, empty cells for NaN."""
        cols = self.columns()
        self.paths.timeseries.parent.mkdir(parents=True, exist_ok=True)
        with open(self.paths.timeseries, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(cols)
            for r in self._records:
                vals = (r.get(c, math.nan) for c in cols)
                w.writerow(["" if math.isnan(v) else repr(v) for v in vals])

    def log_progress(self, iter, num_steps, t, t_end, runtime) -> None:
        logger.info(
            "--- iter: %5d/%5d --- time: %3.3f/%3.3f --- elapsed %5.5f ---",
            iter, num_steps, t, t_end, runtime,
        )

    def reset(self) -> None:
        self._records.clear()
