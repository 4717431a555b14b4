"""Field snapshots, the timeseries CSV and the restart sidecar.

The counterpart of ``flowcontrol_tpu/core/exporter.py`` (ref:
src/flowcontrol/exporter.py):

- U / Uprev / P snapshot triplets (full field = perturbation +
  adjust_baseflow·base), one ``.ckpt`` directory each (``mesh/io.py``; the
  JAX package writes HDF5 files of the same stem);
- a JSON restart sidecar with exactly the keys Tstart, dt, save_every,
  checkpoints_written, restart_order and files{U, Uprev, P} (ref:
  exporter.py:234-262), rewritten at every checkpoint so that a killed run
  restarts from its last one;
- Paraview ``.xdmf`` indexes over the U and P snapshots;
- the timeseries: one row per logged step, with the same columns in the
  same order as the reference's DataFrame (first appearance: time, dE,
  runtime, y_meas_*, then u_ctrl_*), written with the ``csv`` module so the
  run needs no pandas;
- progress logging.
"""

from __future__ import annotations

import csv
import json
import logging
import math

import numpy as np

from flowcontrol_tpu_torch.core.flowfield import FlowFieldCollection, SimPaths
from flowcontrol_tpu_torch.mesh.io import FieldCheckpointFile, write_xdmf_timeseries_index

logger = logging.getLogger(__name__)


class FlowExporter:
    """Snapshot export, the restart sidecar, and the timeseries with CSV
    output."""

    def __init__(
        self,
        paths: SimPaths,
        fields: FlowFieldCollection,
        space,
        Tstart: float = 0.0,
        dt: float = 0.0,
        save_every: int = 0,
    ) -> None:
        self.paths = paths
        self.fields = fields
        self.space = space
        self._Tstart = Tstart
        self._dt = dt
        self._save_every = save_every
        self._records: list[dict] = []
        self._checkpoints_written = 0
        self._files: dict = {}

    # ── Field export ─────────────────────────────────────────────────────────

    def _file(self, path, mode: str = "a") -> FieldCheckpointFile:
        key = str(path)
        if mode == "w" or key not in self._files:
            self._files[key] = FieldCheckpointFile(path, mode)
        return self._files[key]

    def export_snapshots(
        self,
        u_n: np.ndarray,
        u_nn: np.ndarray,
        p_n: np.ndarray,
        time: float,
        append: bool = True,
        adjust_baseflow: float = 0.0,
    ) -> None:
        """Write U/Uprev/P snapshots (ref: exporter.py:85-165);
        ``append=False`` empties the three files first.

        ``adjust_baseflow``: 0 → perturbation only, 1 → full field.
        """
        pmbf = adjust_baseflow
        u0 = self.fields.U0 if self.fields.U0 is not None else 0.0
        p0 = self.fields.P0 if self.fields.P0 is not None else 0.0
        usave = np.asarray(u_n) + pmbf * np.asarray(u0)
        usave_n = np.asarray(u_nn) + pmbf * np.asarray(u0)
        psave = np.asarray(p_n) + pmbf * np.asarray(p0)
        self.fields.Usave, self.fields.Usave_n, self.fields.Psave = usave, usave_n, psave
        mode = "a" if append else "w"
        self._checkpoints_written += 1
        self._file(self.paths.U_restart, mode).write("U", usave, time)
        self._file(self.paths.Uprev_restart, mode).write("U_n", usave_n, time)
        self._file(self.paths.P_restart, mode).write("P", psave, time)

    # the reference's method name
    export_xdmf = export_snapshots

    def write_metadata(self, restart_order=2) -> None:
        """The JSON restart sidecar (ref: exporter.py:234-262)."""
        meta = {
            "Tstart": self._Tstart,
            "dt": self._dt,
            "save_every": self._save_every,
            "checkpoints_written": self._checkpoints_written,
            "restart_order": restart_order,
            "files": {
                "U": self.paths.U_restart.name,
                "Uprev": self.paths.Uprev_restart.name,
                "P": self.paths.P_restart.name,
            },
        }
        self.paths.metadata.parent.mkdir(parents=True, exist_ok=True)
        self.paths.metadata.write_text(json.dumps(meta, indent=2))

    def write_paraview_index(self) -> None:
        """Paraview ``.xdmf`` indexes beside the U and P snapshot files
        (``mesh/io.py`` ``write_xdmf_timeseries_index``)."""
        for path, name in ((self.paths.U_restart, "U"), (self.paths.P_restart, "P")):
            if self._file(path).n_checkpoints(name):
                write_xdmf_timeseries_index(path, self.space.mesh, name)

    # ── Timeseries ───────────────────────────────────────────────────────────

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
        self._checkpoints_written = 0

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
