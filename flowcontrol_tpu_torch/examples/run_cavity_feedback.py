"""Open cavity Re=7500 with closed-loop volume-force feedback (BASELINE.json
config #3), on the card unless asked for the CPU.

    python -m flowcontrol_tpu_torch.examples.run_cavity_feedback [--steps 4000] [--open-loop] [--device cpu]

The port's copy of ``examples/run_cavity_feedback.py``: the loop the
reference defines but never closes, its wall-shear sensor and the upstream
Gaussian volume-force actuator (ref:
src/examples/cavity/cavityflowsolver.py:254-268), closed by the LQG
compensator synthesized at the generated default mesh (120,068 dofs) by
``flowcontrol_tpu_torch/tools/cavity_feedback_synth.py``, from 1e-3 x the
real part of that mesh's leading eigenmode. It compares the perturbation
energy of the closed loop against the open loop's. The JAX example runs on
the stock 235,374-dof mesh, which this repository does not hold, with
inputs synthesized there.

Its inputs are the committed files at the solver's dof count
(``models/cavity.py`` ``cavity_feedback_files``) unless ``mode`` and
``controller`` name others; each is refused on a mesh other than its own.
The base flow is the committed one where the mesh's checksum matches, else
Picard (10) then Newton (10) on the host. On the card the example's
``solver_backend="dense_lu"`` in f32 lands on the multifrontal solve at
120,068 dofs (the dense LU's 16 n^2 bytes, ~230 GB, are past
``dense_lu_max_dofs_device``): the log names the solve. It returns the timeseries as {column: values}, where the JAX
example returns a DataFrame.
"""

import argparse
import logging
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.models.baseflows import committed_baseflow
from flowcontrol_tpu_torch.models.cavity import (
    CavityFlowSolver,
    load_cavity_controller,
    load_cavity_mode,
)

log = logging.getLogger("cavity_feedback")

RE = 7500.0


def make_flow(num_steps: int, mesh=None, device=None, **solver_kwargs) -> CavityFlowSolver:
    """The example's solver (``dense_lu`` in f32 unless ``solver_kwargs``
    say otherwise) with its base flow."""
    fs = CavityFlowSolver.make_default(
        Re=RE, mesh=mesh, num_steps=num_steps, save_every=0, verbose=10,
        device="cuda" if device is None else device,
        path_out=Path.cwd() / "data_output_cavity_feedback",
        **{"solver_backend": "dense_lu", "precision": "f32", **solver_kwargs},
    )
    path = committed_baseflow(fs)
    if path is not None:
        fs.load_steady_state(path)
        log.info("loaded committed base flow %s", path.name)
    else:
        # ref recipe (run_cavity_example.py:70-71)
        fs.compute_steady_state(method="picard", max_iter=10, tol=1e-7, u_ctrl=[0.0])
        fs.compute_steady_state(method="newton", max_iter=10, u_ctrl=[0.0],
                                initial_guess=fs.fields.UP0)
    return fs


def start(fs, mode: dict) -> None:
    """Initialise ``fs`` on 1e-3 x Re(v) of the leading mode. A Stepper
    ``fs`` already holds is kept, factor and graphs, with a new carry."""
    # initialize ON the leading mode (synthesized artifact): the
    # closed-vs-open contrast then measures the subspace the controller
    # targets — a generic Gaussian bump mostly excites stable transients
    # that swamp it at a 400-step horizon (measured: identical dE)
    fs.params_ic.amplitude = 0.0
    ic = 1e-3 * np.asarray(mode["v_re"], dtype=float)
    log.info("IC = 1e-3 x Re(v) of mode %s", mode["eig"])
    stepper = fs._stepper
    fs.initialize_time_stepping(ic=ic)
    if stepper is not None:
        fs._carry = stepper.init_carry(np.concatenate([fs.fields.u_n.reshape(-1), fs.fields.p_n]))
        fs.first_step = False


def run(fs, num_steps: int, k=None) -> None:
    """The example's loop: ``num_steps`` of ``fs.step``, fed by the host
    ``Controller.step`` of ``k`` (None: u = 0)."""
    dt = fs.params_time.dt
    for i in range(num_steps):
        if k is not None:
            # u = +K(y): the interconnection whose closed-loop spectrum
            # the synthesis tool certifies (see run_pinball_feedback.py)
            u_ctrl = k.step(y=np.asarray(fs.y_meas), dt=dt)
        else:
            u_ctrl = np.zeros(1)
        fs.step(u_ctrl=np.asarray(u_ctrl).reshape(-1))
        if i == 0:
            log.info("solve kinds %s (%s, %s)", fs.stepper._solver_kinds, fs.stepper.device,
                     fs.stepper.dtype)


def main(num_steps: int = 400, closed_loop: bool = True, mode=None, controller=None,
         mesh=None, device=None, **solver_kwargs) -> dict:
    """Run the loop, closed (``closed_loop``) or open, for ``num_steps``;
    ``mode`` and ``controller`` are paths (default: the committed files at
    the mesh's dof count)."""
    fs = make_flow(num_steps, mesh=mesh, device=device, **solver_kwargs)
    start(fs, load_cavity_mode(fs, mode))
    k = load_cavity_controller(fs, controller) if closed_loop else None
    run(fs, num_steps, k)
    fs.write_timeseries()

    ts = fs.timeseries
    de = ts["dE"]
    log.info("mode=%s  dE: start %.3e  peak %.3e  end %.3e",
             "closed" if closed_loop else "open", de[0], de.max(), de[-1])
    print(f"{'closed' if closed_loop else 'open'}-loop: "
          f"dE_end={de[-1]:.4e} dE_peak={de.max():.4e} "
          f"y_last={np.asarray(fs.y_meas).round(6)}")
    return ts


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--open-loop", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    on_cpu = args.device == "cpu"
    main(num_steps=args.steps, closed_loop=not args.open_loop, device=args.device,
         **({"solver_backend": "host_lu", "precision": "f64"} if on_cpu else {}))
