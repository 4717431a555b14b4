"""Fluidic pinball with MIMO closed-loop rotation feedback (BASELINE.json
config #4), on the card unless asked for the CPU.

    python -m flowcontrol_tpu_torch.examples.run_pinball_feedback [--steps 400] [--open-loop]
        [--re 100] [--device cpu]

The port's copy of ``examples/run_pinball_feedback.py``: three independently
rotating cylinders driven by an LQG compensator fed by the three
downstream V-sensors, closed u = +K(y). It reads the files
``flowcontrol_tpu_torch/tools/pinball_mimo_synth.py`` writes for the
solver's Re and mesh (``models/pinball.py`` ``pinball_feedback_files``;
committed at Re=100 on the generated default mesh, 67,920 dofs), starts from
amp x the real part of the leading eigenmode (amp 2e-4 from Re 80 up, else
1e-3) and compares the perturbation energy of the closed loop against the
open loop's. Where no mode file fits the mesh it starts from a small
div-free bump downstream; where the compensator is missing it stops and
says to run the synthesis tool. The JAX example runs on the stock
302,035-dof mesh, which this repository does not hold, with inputs
synthesized there; the JAX package's stock-mesh compensator
(``models/_controllers/pinball_lqg_re100.mat``, its own spectral radius
4.50 a step) drives this mesh's plant unstable within about 20 steps and
is no longer the example's.

The base flow is the committed one, or one in the output directory, where
the mesh's checksum matches, else ``models/make_baseflow.pinball_baseflow``
computes it on the host (continuation in Re, or Picard then Newton) and
writes it into the output directory. It returns the timeseries as
{column: values}, where the JAX example returns a DataFrame.
"""

import argparse
import logging
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.core.actuator import CYLINDER_ACTUATION_MODE
from flowcontrol_tpu_torch.models.make_baseflow import pinball_baseflow
from flowcontrol_tpu_torch.models.pinball import (
    PinballFlowSolver,
    load_pinball_controller,
    load_pinball_mode,
    pinball_feedback_files,
)

log = logging.getLogger("pinball_feedback")

RE = 100.0


def ic_amplitude(re: float) -> float:
    """The initial amplitude on Re(v) (the JAX example's ``:70``): small
    enough that the closed leg's spillover transient stays linear."""
    return 2e-4 if re >= 80.0 else 1e-3


def make_flow(num_steps: int, re: float = RE, mesh=None, device=None, path_out=None,
              **solver_kwargs) -> PinballFlowSolver:
    """The example's solver (rotation actuation; unless ``solver_kwargs``
    say otherwise, f32 through the multifrontal solve, ``force_substructure``:
    at 67,920 dofs the dense LU fits a clean card but steps ~17x slower)
    with its base flow (``pinball_baseflow``: its output directory
    ``path_out``, default ``./data_output_pinball_feedback``, holds one it
    computes)."""
    fs = PinballFlowSolver.make_default(
        Re=re, mesh=mesh, num_steps=num_steps, save_every=0, verbose=10,
        device="cuda" if device is None else device,
        mode_actuation=CYLINDER_ACTUATION_MODE.ROTATION,
        path_out=Path.cwd() / "data_output_pinball_feedback" if path_out is None else path_out,
        **{"solver_backend": "dense_lu", "precision": "f32",
           "stepper_options": {"force_substructure": True}, **solver_kwargs},
    )
    pinball_baseflow(fs, fs.params_save.path_out)
    return fs


def start(fs, mode: dict | None) -> None:
    """Initialise ``fs`` on amp x Re(v) of the leading mode (``mode``; None:
    the small bump). A Stepper ``fs`` already holds is kept, factor and
    graphs, with a new carry."""
    ic = None
    if mode is not None:
        # initialize ON the leading unstable mode (see run_cavity_feedback.py);
        # the amplitude keeps the closed leg's spillover transient linear
        fs.params_ic.amplitude = 0.0
        amp = ic_amplitude(fs.params_flow.Re)
        ic = amp * np.asarray(mode["v_re"], dtype=float)
        log.info("IC = %g x Re(v) of mode %s", amp, mode["eig"])
    else:
        fs.params_ic.xloc, fs.params_ic.yloc = 1.0, 0.0
        fs.params_ic.radius, fs.params_ic.amplitude = 0.6, 0.01
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
            # u = +K(y): lqg_regulator's compensator consumes the raw
            # measurement (its B_K already carries the Kalman gain sign); the
            # closed-loop spectrum certified by the synthesis tool is the
            # [[A, B·K_C], [K_B·C, K_A]] interconnection. (The reference's
            # u = Kss.step(-y) convention belongs to ITS Kopt artifact ---
            # ref: run_cylinder_example.py:84-86.)
            u_ctrl = k.step(y=np.asarray(fs.y_meas), dt=dt)
        else:
            u_ctrl = np.zeros(3)
        fs.step(u_ctrl=np.asarray(u_ctrl).reshape(-1))
        if i == 0:
            log.info("solve kinds %s (%s, %s)", fs.stepper._solver_kinds, fs.stepper.device,
                     fs.stepper.dtype)


def find_mode(fs, path=None) -> dict | None:
    """The leading mode for ``fs``'s Re and mesh (``path`` or the committed
    file), or None where none fits."""
    path = Path(path or pinball_feedback_files(fs.space.n_dofs, fs.params_flow.Re)["mode"])
    if not path.exists():
        return None
    try:
        return load_pinball_mode(fs, path)
    except ValueError as err:
        log.info("no mode file fits this mesh (%s): the bump instead", err)
        return None


def main(num_steps: int = 400, closed_loop: bool = True, re: float = RE, mode=None,
         controller=None, mesh=None, device=None, path_out=None, **solver_kwargs) -> dict:
    """Run the loop, closed (``closed_loop``) or open, for ``num_steps``;
    ``mode`` and ``controller`` are paths (default: the committed files at
    the Re and the mesh's dof count)."""
    fs = make_flow(num_steps, re=re, mesh=mesh, device=device, path_out=path_out,
                   **solver_kwargs)
    start(fs, find_mode(fs, mode))
    k = None
    if closed_loop:
        kpath = Path(controller or pinball_feedback_files(fs.space.n_dofs, re)["lqg"])
        if not kpath.exists():
            raise SystemExit(f"{kpath} missing — run tools/pinball_mimo_synth first "
                             f"(python -m flowcontrol_tpu_torch.tools.pinball_mimo_synth "
                             f"--re {re:g})")
        k = load_pinball_controller(fs, kpath)
    run(fs, num_steps, k)
    fs.write_timeseries()

    de = fs.timeseries["dE"]
    log.info("mode=%s  dE: start %.3e  peak %.3e  end %.3e",
             "closed" if closed_loop else "open", de[0], de.max(), de[-1])
    print(f"{'closed' if closed_loop else 'open'}-loop: "
          f"dE_end={de[-1]:.4e} dE_peak={de.max():.4e} "
          f"y_last={np.asarray(fs.y_meas).round(6)}")
    return fs.timeseries


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--open-loop", action="store_true")
    ap.add_argument("--re", type=float, default=RE,
                    help="Reynolds number (the compensator pinball_lqg_re<Re>_n<dofs>.mat "
                    "must exist)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    on_cpu = args.device == "cpu"
    main(num_steps=args.steps, closed_loop=not args.open_loop, re=args.re, device=args.device,
         **({"solver_backend": "host_lu", "precision": "f64", "stepper_options": {}}
            if on_cpu else {}))
