"""FlowSolver: the abstract simulation class.

The counterpart of ``flowcontrol_tpu/core/flowsolver.py`` (ref:
src/flowcontrol/flowsolver.py): same constructor over the 8 Param* objects,
same lifecycle (_setup → compute_steady_state → initialize_time_stepping →
step loop) and the same divergence semantics (throw_error=False returns None
so optimization loops can score diverged candidates — ref:
flowsolver.py:727-737).

The mesh, spaces, BCs and the base flow are host float64 numpy/scipy; the
time-stepping hot loop is a :class:`Stepper` on ``ParamSolver.device``.
The closed loop runs through ``step`` with the port's ``Controller``
(``u = K.step(y, dt); fs.step(u_ctrl=u)``); rollouts of many streams and the
fused closed loop are the Stepper's (``rollout_open_loop``,
``rollout_closed_loop``). Meshes, snapshots, the restart sidecar and the
steady state go to and come from the port's files (``mesh/io.py``: ``.xdmf``
indexes over ``.npy`` arrays, ``.ckpt`` snapshot directories), and the
JAX package's HDF5 files are read through h5py where it is installed; a
restart (``Tstart > 0``) steps at BDF2 from its first step, as the JAX
package's does. Subclass API:

    _make_boundaries() -> dict[str, predicate(midpoints)->mask]
    _make_bcs()        -> BoundaryConditions (first bcu entry MUST be inlet)
    make_default()     -> classmethod factory
"""

from __future__ import annotations

import json
import logging
import time
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np
import torch

from flowcontrol_tpu_torch.config import device_dtype, require_device
from flowcontrol_tpu_torch.core import flowsolverparameters as fsp
from flowcontrol_tpu_torch.core.actuator import ACTUATOR_TYPE
from flowcontrol_tpu_torch.core.exporter import FlowExporter
from flowcontrol_tpu_torch.core.flowfield import (
    BoundaryConditions,
    FlowField,
    FlowFieldCollection,
    SimPaths,
)
from flowcontrol_tpu_torch.core.nsforms import NSForms
from flowcontrol_tpu_torch.core.sensor import sensor_matrix
from flowcontrol_tpu_torch.core.steadystate import SteadyStateSolver
from flowcontrol_tpu_torch.core.stepper import Stepper
from flowcontrol_tpu_torch.fem.assembly import (
    CellGeometry,
    load_vector,
    quadrature_points_physical,
)
from flowcontrol_tpu_torch.fem.bc import BCSet, DirichletBC
from flowcontrol_tpu_torch.fem.projection import (
    l2_norm_velocity,
    project_velocity,
    project_velocity_nodal_constrained,
)
from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace
from flowcontrol_tpu_torch.mesh.io import (
    SNAPSHOT_SUFFIX,
    read_field_snapshot,
    read_xdmf_mesh,
    write_field_snapshot,
)
from flowcontrol_tpu_torch.utils.physics import get_div0_u_callable

logger = logging.getLogger(__name__)

#: the 'auto' backend picks dense_lu at or below this many dofs on any device
DENSE_LU_MAX_DOFS = 20_000


class FlowSolver(ABC):
    """Abstract base class for flow simulation and control."""

    def __init__(
        self,
        params_flow: fsp.ParamFlow,
        params_time: fsp.ParamTime,
        params_save: fsp.ParamSave,
        params_solver: fsp.ParamSolver,
        params_mesh: fsp.ParamMesh,
        params_control: fsp.ParamControl,
        params_ic: fsp.ParamIC,
        params_restart: fsp.ParamRestart | None = None,
        verbose: int = 1,
    ) -> None:
        self._validate_params(
            params_flow, params_time, params_save, params_solver,
            params_mesh, params_control, params_ic, params_restart,
        )
        # fail before the host set-up when the default card is absent
        require_device(params_solver.device)
        self.params_flow = params_flow
        self.params_time = params_time
        self.params_save = params_save
        self.params_solver = params_solver
        self.params_mesh = params_mesh
        self.params_restart = params_restart
        self.params_control = params_control
        self.params_ic = params_ic
        self.verbose = verbose
        self._setup()

    # ── Validation (ref: flowsolver.py:108-165) ──────────────────────────────

    @staticmethod
    def _validate_params(
        params_flow, params_time, params_save, params_solver,
        params_mesh, params_control, params_ic, params_restart=None,
    ) -> None:
        if params_time.dt <= 0:
            raise ValueError(f"dt must be positive, got {params_time.dt}")
        if params_time.num_steps < 0:
            raise ValueError(f"num_steps must be non-negative, got {params_time.num_steps}")
        if params_flow.Re <= 0:
            raise ValueError(f"Re must be positive, got {params_flow.Re}")
        if params_save.save_every < 0:
            raise ValueError(f"save_every must be non-negative, got {params_save.save_every}")
        if params_save.energy_every < 0:
            raise ValueError(f"energy_every must be non-negative, got {params_save.energy_every}")
        if len(params_control.actuator_list) != params_control.actuator_number:
            raise ValueError("actuator_list length does not match actuator_number")
        if len(params_control.sensor_list) != params_control.sensor_number:
            raise ValueError("sensor_list length does not match sensor_number")
        if params_mesh.mesh is None and not params_mesh.meshpath.exists():
            raise FileNotFoundError(f"Mesh file not found at {params_mesh.meshpath}")
        if params_restart is not None and params_restart.Trestartfrom < 0:
            raise ValueError("Trestartfrom must be non-negative")

    # ── Setup (ref: flowsolver.py:169-201) ───────────────────────────────────

    def _setup(self) -> None:
        self.fields = FlowFieldCollection()
        self.E0: float = 0.0
        self.paths = self._define_paths()
        self.mesh = self._make_mesh()
        self.space = TaylorHoodSpace.build(self.mesh)
        self.geom = CellGeometry(self.space)
        self.boundaries = self._make_boundaries()  # dict name -> predicate
        self.markers = self.mesh.mark_boundaries(self.boundaries)
        for name in self.boundaries:
            if len(self.markers.facets(name)) == 0:
                logger.warning(
                    f"boundary {name!r} matches no facets — check domain "
                    "extents vs the mesh"
                )
        self._load_actuators()
        self._load_sensors()
        self.bc = self._make_bcs()  # abstract
        self.forms = NSForms(
            space=self.space,
            geom=self.geom,
            Re=self.params_flow.Re,
            dt=self.params_time.dt,
            is_nonlinear=self.params_solver.is_eq_nonlinear,
            shift=self.params_solver.shift,
        )
        self.exporter = FlowExporter(
            paths=self.paths,
            fields=self.fields,
            space=self.space,
            Tstart=self.params_time.Tstart,
            dt=self.params_time.dt,
            save_every=self.params_save.save_every,
        )
        self._stepper: Stepper | None = None
        self._force_cols = self._make_force_columns()
        self.y_meas = np.zeros(self.params_control.sensor_number)
        logger.info(
            f"DOFs: {self.space.n_dofs} ({self.space.n_vel_dofs} velocity "
            f"+ {self.space.n_pressure_dofs} pressure)"
        )

    def _define_paths(self) -> SimPaths:
        """(ref: flowsolver.py:205-231); snapshot files are the port's
        (``mesh/io.py``) where the JAX package writes ``.h5`` files."""

        def ext(T: float) -> str:
            return f"_restart{T:.3f}".replace(".", ",")

        Tstart = self.params_time.Tstart
        Trestartfrom = self.params_restart.Trestartfrom if self.params_restart else 0.0
        path_out = self.params_save.path_out
        return SimPaths(
            U0=path_out / "steady" / ("U0" + SNAPSHOT_SUFFIX),
            P0=path_out / "steady" / ("P0" + SNAPSHOT_SUFFIX),
            steady_meta=path_out / "steady" / "meta.json",
            U=path_out / ("U" + ext(Trestartfrom) + SNAPSHOT_SUFFIX),
            P=path_out / ("P" + ext(Trestartfrom) + SNAPSHOT_SUFFIX),
            Uprev=path_out / ("Uprev" + ext(Trestartfrom) + SNAPSHOT_SUFFIX),
            U_restart=path_out / ("U" + ext(Tstart) + SNAPSHOT_SUFFIX),
            Uprev_restart=path_out / ("Uprev" + ext(Tstart) + SNAPSHOT_SUFFIX),
            P_restart=path_out / ("P" + ext(Tstart) + SNAPSHOT_SUFFIX),
            timeseries=path_out / ("timeseries1D" + ext(Tstart) + ".csv"),
            metadata=path_out / ("meta" + ext(Tstart) + ".json"),
            mesh=self.params_mesh.meshpath,
        )

    def _make_mesh(self):
        if self.params_mesh.mesh is not None:
            return self.params_mesh.mesh
        logger.info(f"Mesh @ {self.params_mesh.meshpath}")
        mesh = read_xdmf_mesh(self.params_mesh.meshpath)
        logger.info(f"Mesh has {mesh.num_cells} cells")
        return mesh

    def _load_actuators(self) -> None:
        for actuator in self.params_control.actuator_list:
            actuator.load_expression(self)

    def _load_sensors(self) -> None:
        for sensor in self.params_control.sensor_list:
            sensor.load(self)

    def _make_force_columns(self) -> np.ndarray:
        """Per-actuator body-force load vectors (n_act, n_dofs).

        FORCE actuators assemble ∫ f·v dx once (ref: operatorgetter.py:163-168);
        BC actuators contribute zero columns here (they act through lifting).
        """
        n_act = self.params_control.actuator_number
        cols = np.zeros((n_act, self.space.n_dofs))
        qp = quadrature_points_physical(self.space)
        for i, act in enumerate(self.params_control.actuator_list):
            if act.actuator_type is ACTUATOR_TYPE.FORCE:
                fq = act.profile(qp.reshape(-1, 2)).reshape(qp.shape[0], 7, 2)
                cols[i] = np.asarray(load_vector(self.geom, self.space, fq))
        return cols

    # ── BC helpers (replace dolfin.DirichletBC) ──────────────────────────────

    def dirichlet_bc(
        self,
        boundary_name: str,
        value: float | Sequence[float] = (0.0, 0.0),
        component: int | None = None,
        actuator: int | None = None,
    ) -> DirichletBC:
        """Build a velocity Dirichlet BC on a named boundary.

        ``component=None`` constrains both velocity components (dolfin
        ``W.sub(0)``); ``component=0/1`` constrains a single one
        (``W.sub(0).sub(c)``). ``actuator=i`` makes the BC value
        ``u_ctrl[i] * actuator.profile(x)`` (+ static value).
        """
        nodes = self.space.boundary_vel_nodes(self.markers.facets(boundary_name))
        coords = self.space.vel_node_coords[nodes]
        if actuator is not None:
            act = self.params_control.actuator_list[actuator]
            prof = act.profile(coords)  # (m, 2)
            dofs = np.concatenate([2 * nodes, 2 * nodes + 1])
            profile = np.concatenate([prof[:, 0], prof[:, 1]])
            return DirichletBC(
                dofs=dofs,
                values=np.zeros(len(dofs)),
                actuator_index=actuator,
                profile=profile,
            )
        if component is None:
            value = np.broadcast_to(np.asarray(value, dtype=float), (2,))
            dofs = np.concatenate([2 * nodes, 2 * nodes + 1])
            values = np.concatenate(
                [np.full(len(nodes), value[0]), np.full(len(nodes), value[1])]
            )
            return DirichletBC(dofs=dofs, values=values)
        dofs = 2 * nodes + component
        return DirichletBC(dofs=dofs, values=np.full(len(nodes), float(value)))

    def _pin_pressure_needed(self, bcset: BCSet) -> bool:
        """Detect enclosed flows (pressure defined up to a constant)."""
        if self.params_solver.pin_pressure is not None:
            return self.params_solver.pin_pressure
        bnodes = self.space.boundary_vel_nodes(
            np.arange(self.mesh.boundary_facets.shape[0])
        )
        bdofs = np.concatenate([2 * bnodes, 2 * bnodes + 1])
        return bool(np.isin(bdofs, bcset.dofs).all())

    def _bcset_perturbation(self) -> BCSet:
        bcset = BCSet(self.bc.bcu, self.space.n_dofs)
        if self._pin_pressure_needed(bcset):
            pin = DirichletBC(dofs=np.array([2 * self.space.n_vnodes]), values=0.0)
            bcset = BCSet(self.bc.bcu + [pin], self.space.n_dofs)
        return bcset

    def _make_BCs(self) -> BoundaryConditions:
        """Full-field BCs: uniform inlet merged with perturbation side BCs
        (ref: flowsolver.py:329-337)."""
        bcu_inlet = self.dirichlet_bc("inlet", value=(self.params_flow.uinf, 0.0))
        bcs = self._make_bcs()
        return BoundaryConditions(bcu=[bcu_inlet] + bcs.bcu[1:], bcp=[])

    # ── Actuator amplitude API (ref: flowsolver.py:278-309) ─────────────────

    def set_actuators_u_ctrl(self, u_ctrl: Iterable) -> None:
        u_ctrl = list(u_ctrl)
        if len(u_ctrl) != self.params_control.actuator_number:
            raise ValueError(
                f"Expected {self.params_control.actuator_number} control inputs, "
                f"got {len(u_ctrl)}"
            )
        for actuator, val in zip(self.params_control.actuator_list, u_ctrl):
            actuator.u_ctrl = float(val)

    def flush_actuators_u_ctrl(self) -> None:
        self.set_actuators_u_ctrl([0] * self.params_control.actuator_number)

    def get_actuators_u_ctrl(self) -> list:
        return [a.u_ctrl for a in self.params_control.actuator_list]

    def make_measurement(self, up: np.ndarray) -> np.ndarray:
        """Evaluate all sensors on a mixed field (ref: flowsolver.py:311-325)."""
        return np.array(
            [s.eval(up=np.asarray(up)) for s in self.params_control.sensor_list]
        )

    # ── Steady state (ref: flowsolver.py:341-460) ────────────────────────────

    def compute_steady_state(
        self,
        u_ctrl: list,
        method: str = "newton",
        initial_guess: np.ndarray | None = None,
        max_iter: int = 10,
        **kwargs,
    ) -> None:
        self.set_actuators_u_ctrl(u_ctrl)
        f_load = self._force_cols.T @ np.asarray(u_ctrl, dtype=float) if len(u_ctrl) else None

        up0 = self._define_initial_guess(initial_guess)
        full_bcs = BCSet(self._make_BCs().bcu, self.space.n_dofs)
        if self._pin_pressure_needed(full_bcs):
            pin = DirichletBC(dofs=np.array([2 * self.space.n_vnodes]), values=0.0)
            full_bcs = BCSet(self._make_BCs().bcu + [pin], self.space.n_dofs)
        ss = SteadyStateSolver(
            space=self.space,
            geom=self.geom,
            bcs=full_bcs,
            inv_re=1.0 / self.params_flow.Re,
            f_load=f_load,
            verbose=bool(self.verbose),
        )
        if method == "newton":
            up0 = ss.newton(up0, max_iter=max_iter, u_ctrl=u_ctrl, **kwargs)
        elif method == "picard":
            up0 = ss.picard(up0, max_iter=max_iter, u_ctrl=u_ctrl, **kwargs)
        else:
            raise ValueError(f"method must be 'newton' or 'picard', got {method!r}")

        field = FlowField(up0, self.space)
        if self.params_save.save_every:
            write_field_snapshot(self.paths.U0, "U0", field.u, 0.0, append=False)
            write_field_snapshot(self.paths.P0, "P0", field.p, 0.0, append=False)
            self.paths.steady_meta.parent.mkdir(parents=True, exist_ok=True)
            self.paths.steady_meta.write_text(
                json.dumps({"mesh_cells": self.mesh.num_cells}, indent=2)
            )
        self._assign_steady_state(field.u.copy(), field.p.copy())

    def load_steady_state(self, path_u_p: str | Path | Sequence[Path] | None = None) -> None:
        """Base flow from the U0/P0 snapshot pair (default: the pair
        ``compute_steady_state`` writes under ``path_out/steady``; a
        ``meta.json`` beside U0 that records another cell count raises
        ``ValueError``), or from one ``.npz`` path holding ``U0``
        (n_vnodes, 2) and ``P0`` (nv,), the format of the reference's
        ``models/_baseflows/``, read as plain arrays (no pickled objects)."""
        if isinstance(path_u_p, (str, Path)):
            with np.load(path_u_p, allow_pickle=False) as d:
                self._assign_steady_state(np.asarray(d["U0"]), np.asarray(d["P0"]))
            return
        paths = path_u_p or (self.paths.U0, self.paths.P0)
        self._check_steady_state_compatible(Path(paths[0]))
        u0 = read_field_snapshot(paths[0], "U0", 0)
        p0 = read_field_snapshot(paths[1], "P0", 0)
        self._assign_steady_state(u0, p0)

    def _check_steady_state_compatible(self, u0_path: Path) -> None:
        meta_path = u0_path.parent / "meta.json"
        try:
            meta = json.loads(meta_path.read_text())
        except FileNotFoundError:
            meta = {}
        stored = meta.get("mesh_cells")
        if stored is not None and stored != self.mesh.num_cells:
            raise ValueError(
                f"Steady-state checkpoint at {u0_path.parent} was written with "
                f"{stored} mesh cells, but the current mesh has "
                f"{self.mesh.num_cells}."
            )

    def _assign_steady_state(self, u0: np.ndarray, p0: np.ndarray) -> None:
        """Adopt a base flow: velocity (n_vnodes, 2) and pressure (nv,), e.g.
        the arrays the JAX package's solver computed on the same mesh."""
        u0 = np.asarray(u0, dtype=float)
        p0 = np.asarray(p0, dtype=float)
        if u0.shape != (self.space.n_vnodes, 2) or p0.shape != (self.space.n_pressure_dofs,):
            raise ValueError(
                f"base flow shapes {u0.shape}, {p0.shape} do not match the mesh "
                f"({self.space.n_vnodes}, 2), ({self.space.n_pressure_dofs},)"
            )
        self.fields.U0 = u0
        self.fields.P0 = p0
        self.fields.UP0 = np.concatenate([u0.reshape(-1), p0])
        self.E0 = 0.5 * l2_norm_velocity(self.geom, self.space, u0) ** 2

    def _define_initial_guess(self, initial_guess=None) -> np.ndarray:
        if initial_guess is not None:
            return np.asarray(initial_guess, dtype=float)
        logger.info("Steady-state solver — no initial guess provided, using default")
        up = np.zeros(self.space.n_dofs)
        u = self._default_steady_state_initial_guess()
        up[: self.space.n_vel_dofs] = u.reshape(-1)
        return up

    def _default_steady_state_initial_guess(self) -> np.ndarray:
        """Uniform flow at uinf (ref: flowsolver.py:887-900)."""
        u = np.zeros((self.space.n_vnodes, 2))
        u[:, 0] = self.params_flow.uinf
        return u

    # ── Time stepping (ref: flowsolver.py:464-799) ───────────────────────────

    def initialize_time_stepping(self, Tstart: float = 0.0, ic=None) -> None:
        """From the initial condition ``ic`` (``Tstart == 0``) or from the
        checkpoint at ``Tstart``, found through a JSON sidecar in
        ``path_out`` or, without one, ``ParamRestart``."""
        restart_order = (
            self.params_restart.restart_order if self.params_restart else "n/a"
        )
        logger.info(f"Initialising from t={Tstart}, restart_order={restart_order}")
        if Tstart == 0.0:
            u_, p_, u_n, u_nn, p_n = self._initialize_with_ic(ic)
        else:
            u_, p_, u_n, u_nn, p_n = self._initialize_at_time(Tstart)
        self.fields.u_ = u_
        self.fields.p_ = p_
        self.fields.u_n = u_n
        self.fields.u_nn = u_nn
        self.fields.p_n = p_n

        self.first_step = True
        self.exporter.reset()
        self.y_meas = self.make_measurement(up=self.fields.ic.up)
        self.exporter.log_ic(
            t=self.params_time.Tstart,
            y_meas=self.y_meas,
            dE=self.compute_perturbation_energy(),
        )

    def _initialize_with_ic(self, ic=None):
        self.order = "cn" if self.params_solver.time_scheme == "cn" else 1
        self.iter = 0
        self.t = self.params_time.Tstart

        if ic is None:
            ic_up = np.zeros(self.space.n_dofs)
        else:
            ic_up = np.asarray(ic, dtype=float).copy()

        if self.params_ic.amplitude:
            pert = self._perturbation_div0(
                xloc=self.params_ic.xloc,
                yloc=self.params_ic.yloc,
                radius=self.params_ic.radius,
            )
            ic_up = ic_up + self.params_ic.amplitude * pert
        self.fields.ic = FlowField(ic_up, self.space)

        # Project IC velocity with perturbation BCs applied
        # (ref: flowsolver.py:532 — projectm(ic.u, V, bcs=bc.bcu))
        bcset = self._bcset_perturbation()
        u_n = self._project_ic_velocity(self.fields.ic.u, bcset)
        p_n = self.fields.ic.p.copy()
        u_nn = u_n.copy()
        if self.params_save.save_every:
            self.exporter.export_snapshots(
                u_n, u_nn, p_n, time=0.0, append=False, adjust_baseflow=1.0
            )
        return u_n.copy(), p_n.copy(), u_n, u_nn, p_n

    def _project_ic_velocity(self, u_nodes: np.ndarray, bcset: BCSet) -> np.ndarray:
        """Constrained L2 projection of the IC velocity with the perturbation
        BCs applied to the mass system, matching dolfin's
        projectm(ic.u, V, bcs=bc.bcu) (ref: flowsolver.py:532)."""
        vel_sel = bcset.dofs < self.space.n_vel_dofs
        vdofs = bcset.dofs[vel_sel]
        vvals = np.asarray(bcset.values)[vel_sel]
        return project_velocity_nodal_constrained(
            self.geom, self.space, u_nodes,
            bc_nodes=vdofs // 2, bc_comps=vdofs % 2, bc_vals=vvals,
        )

    def _perturbation_div0(self, xloc=0.0, yloc=0.0, radius=1.0) -> np.ndarray:
        """Div-free Gaussian velocity + base pressure, as a mixed vector
        (the reference merges u_nodiv with projectm(P0, P),
        ref: flowsolver.py:908-912)."""
        u = project_velocity(
            self.geom, self.space, get_div0_u_callable(xloc, yloc, radius)
        )
        p = (
            np.asarray(self.fields.P0, dtype=float)
            if self.fields.P0 is not None
            else np.zeros(self.space.n_pressure_dofs)
        )
        return np.concatenate([u.reshape(-1), p])

    # ── Restart (ref: flowsolver.py:551-663) ─────────────────────────────────

    def _find_restart_source(self, Tstart: float):
        result = self._find_restart_from_json(Tstart)
        if result is not None:
            return result
        return self._find_restart_from_params(Tstart)

    def _find_restart_from_json(self, Tstart: float):
        """The first sidecar in ``path_out`` whose checkpoints cover
        ``Tstart``: (meta, counter, directory), or None."""
        path_out = self.params_save.path_out
        for json_path in sorted(path_out.glob("meta_restart*.json")):
            meta = json.loads(json_path.read_text())
            T0 = meta["Tstart"]
            step = meta["dt"] * meta["save_every"]
            n = meta["checkpoints_written"]
            if n == 0:
                continue
            Tend = T0 + step * n
            if T0 - 1e-10 <= Tstart <= Tend + 1e-10:
                counter = round((Tstart - T0) / step)
                logger.info(f"Restart: found JSON sidecar {json_path.name}, counter={counter}")
                return meta, counter, path_out
        return None

    def _find_restart_from_params(self, Tstart: float):
        """The legacy source: file names from ``ParamRestart.Trestartfrom``,
        the counter from its old dt and save_every."""
        if self.params_restart is None:
            raise FileNotFoundError(
                f"No JSON metadata sidecar found covering Tstart={Tstart} in "
                f"{self.params_save.path_out}, and no ParamRestart was provided."
            )
        pr = self.params_restart
        step = pr.dt_old * pr.save_every_old
        counter = round((Tstart - pr.Trestartfrom) / step)
        meta = {
            "restart_order": pr.restart_order,
            "files": {
                "U": self.paths.U.name,
                "Uprev": self.paths.Uprev.name,
                "P": self.paths.P.name,
            },
        }
        logger.info(f"Restart: using legacy ParamRestart, counter={counter}")
        return meta, counter, self.params_save.path_out

    def _initialize_at_time(self, Tstart: float):
        """The state at ``Tstart`` from a checkpoint (full fields, the base
        flow subtracted); the files the sidecar names may be the JAX
        package's ``.h5`` (read through h5py) or the port's ``.ckpt``."""
        meta, counter, base_dir = self._find_restart_source(Tstart)
        self.order = meta["restart_order"]
        self.iter = 0
        self.t = Tstart

        U_full = read_field_snapshot(base_dir / meta["files"]["U"], "U", counter)
        Unn_full = read_field_snapshot(base_dir / meta["files"]["Uprev"], "U_n", counter)
        P_full = read_field_snapshot(base_dir / meta["files"]["P"], "P", counter)

        if self.params_save.save_every:
            self.exporter.export_snapshots(
                U_full, Unn_full, P_full, time=Tstart, append=False,
                adjust_baseflow=0.0,
            )
        u_ = np.asarray(U_full) - self.fields.U0
        u_n = u_.copy()
        u_nn = np.asarray(Unn_full) - self.fields.U0
        p_ = np.asarray(P_full) - self.fields.P0
        p_n = p_.copy()
        self.fields.ic = FlowField(np.concatenate([u_.reshape(-1), p_]), self.space)
        return u_, p_, u_n, u_nn, p_n

    # ── Stepper construction (ref: _prepare_systems, flowsolver.py:665-701) ──

    @property
    def device(self) -> torch.device:
        return torch.device(self.params_solver.device)

    def _resolve_backend(self) -> str:
        """'auto': dense_lu up to DENSE_LU_MAX_DOFS anywhere and at every
        size on CUDA, where the Stepper takes the dense LU while its f64
        factorization fits the card (``dense_lu_max_dofs_device``) and the
        multifrontal solve past that; the host sparse LU on the CPU beyond
        DENSE_LU_MAX_DOFS (the reference's rule, flowsolver.py:581-598)."""
        b = self.params_solver.solver_backend
        if b != "auto":
            return b
        if self.space.n_dofs <= DENSE_LU_MAX_DOFS or self.device.type == "cuda":
            return "dense_lu"
        return "host_lu"

    def _resolve_dtype(self) -> torch.dtype:
        return device_dtype(self.device, self.params_solver.precision)

    def _prepare_systems(self) -> None:
        if self.fields.U0 is None:
            raise RuntimeError(
                "compute_steady_state or load_steady_state must run before stepping"
            )
        scheme = self.params_solver.time_scheme
        start_order = self.order if self.order in (2, "cn") else 1
        self._stepper = Stepper(
            space=self.space,
            forms=self.forms,
            bcs=self._bcset_perturbation(),
            u0_nodes=self.fields.U0,
            c_rows=sensor_matrix(
                self.params_control.sensor_list, self.space.n_dofs
            ),
            force_cols=self._force_cols,
            scheme=scheme,
            backend=self._resolve_backend(),
            dtype=self._resolve_dtype(),
            device=self.device,
            start_order=start_order if scheme != "cn" else "cn",
            **self.params_solver.stepper_options,
        )
        up_n = np.concatenate([self.fields.u_n.reshape(-1), self.fields.p_n])
        up_nn = np.concatenate([self.fields.u_nn.reshape(-1), self.fields.p_n])
        self._carry = self._stepper.init_carry(up_n, up_nn)
        # the JAX package's jitted step (flowsolver.py:634): on CUDA a CUDA
        # graph of the steady-state step, on the CPU the eager step
        self._step_compiled = self._stepper.compiled_step()

    @property
    def stepper(self) -> Stepper:
        if self._stepper is None:
            self._prepare_systems()
            self.first_step = False
        return self._stepper

    # ── step() (ref: flowsolver.py:703-799) ──────────────────────────────────

    def step(self, u_ctrl) -> np.ndarray | None:
        if self.first_step:
            self._prepare_systems()
            self.first_step = False

        t0 = time.time()
        u_ctrl = np.atleast_1d(np.asarray(u_ctrl, dtype=float))
        self.set_actuators_u_ctrl(u_ctrl)

        self._carry, out = self._step_compiled(self._carry, u_ctrl)
        if bool(out.diverged):
            logger.critical("Solver diverged (Inf detected)")
            if not self.params_solver.throw_error:
                return None
            raise RuntimeError("Failed solving: Inf found in solution")

        x = out.x.detach().cpu().numpy().astype(float)
        self.iter += 1
        self.t = self.params_time.Tstart + self.iter * self.params_time.dt
        if self.params_solver.time_scheme != "cn":
            self.order = 2

        field = FlowField(x, self.space)
        self.fields.u_ = field.u
        self.fields.p_ = field.p
        self.fields.up_ = x
        self.fields.u_nn = self.fields.u_n
        self.fields.u_n = field.u
        self.fields.p_n = field.p

        self.y_meas = out.y.detach().cpu().numpy().astype(float)
        runtime = time.time() - t0

        if self._niter_multiple_of(self.iter, self.verbose):
            self.exporter.log_progress(
                self.iter, self.params_time.num_steps, self.t,
                self.params_time.Tfinal + self.params_time.Tstart, runtime,
            )
        dE = (
            float(out.dE)
            if self._niter_multiple_of(self.iter, self.params_save.energy_every)
            else np.nan
        )
        self.exporter.log(
            u_ctrl=u_ctrl, y_meas=self.y_meas, dE=dE, t=self.t, runtime=runtime
        )
        if self._niter_multiple_of(self.iter, self.params_save.save_every):
            # the checkpoint: snapshots, the sidecar that points at them,
            # the timeseries so far and the Paraview indexes
            self.exporter.export_snapshots(
                self.fields.u_n, self.fields.u_nn, self.fields.p_n,
                time=self.t, adjust_baseflow=1.0,
            )
            self.exporter.write_metadata(
                restart_order="cn" if self.params_solver.time_scheme == "cn" else 2
            )
            self.exporter.write_timeseries()
            self.exporter.write_paraview_index()
        return self.y_meas

    def write_timeseries(self) -> None:
        self.exporter.write_timeseries()

    @property
    def timeseries(self) -> dict[str, np.ndarray]:
        """The logged timeseries as {column: values} (see FlowExporter)."""
        return self.exporter.to_columns()

    def _niter_multiple_of(self, it: int, divider: int) -> bool:
        return bool(divider and not it % divider)

    # ── Energy (ref: flowsolver.py:827-841) ──────────────────────────────────

    def compute_perturbation_energy(self) -> float:
        """½‖u'‖²_L2 of the current perturbation field."""
        return 0.5 * l2_norm_velocity(self.geom, self.space, self.fields.u_) ** 2

    def compute_energy_field(self) -> np.ndarray:
        """Pointwise kinetic-energy density u'·u' at velocity nodes."""
        return (self.fields.u_ ** 2).sum(axis=1)

    # ── Utilities ────────────────────────────────────────────────────────────

    def merge(self, u: np.ndarray, p: np.ndarray) -> np.ndarray:
        """(ref: flowsolver.py:845-862)"""
        return np.concatenate([np.asarray(u).reshape(-1), np.asarray(p)])

    def get_subdomain(self, name: str):
        """Return the boundary predicate for a named region."""
        return self.boundaries[name]

    # ── Abstract methods (ref: flowsolver.py:916-940) ───────────────────────

    @abstractmethod
    def _make_boundaries(self) -> dict:
        """Return {name: predicate(midpoints (nf,2)) -> bool mask}."""

    @abstractmethod
    def _make_bcs(self) -> BoundaryConditions:
        """Perturbation-field BCs; first bcu entry MUST be the inlet."""

    @classmethod
    @abstractmethod
    def make_default(cls, **kwargs) -> "FlowSolver":
        """Instance with standard parameters for the specific flow."""
