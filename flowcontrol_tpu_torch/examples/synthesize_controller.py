"""Model-based controller synthesis from exported operators, and batched
evaluation of the candidates, on the card unless asked for the CPU.

    python -m flowcontrol_tpu_torch.examples.synthesize_controller [--steps 60] [--device cpu]

The port's copy of ``examples/synthesize_controller.py``: the control
design the reference spreads across operator export, Matlab and lticontrol,
in one script:

1. export (A, E, B, C) around the cylinder's base flow (Re=100, the coarse
   generated mesh, 7,889 dofs; Picard then Newton on the host);
2. a reduced model by modal (Petrov-Galerkin) projection onto the leading
   eigenmodes near the shift 0.1 + 0.8j;
3. LQG synthesis on the reduced model (``utils/lticontrol``) over the
   weight grid qx in {0.1, 1, 10};
4. the candidates stacked (``stack_controllers``) and stepped with the
   plant copies in one batched closed-loop rollout (``closed_loop_fn`` at
   B = 3): the replacement of the reference's MPI master-worker
   optimization loop (ref: src/utils/optim.py:71-107).

On the card the flow steps in f32 on the default ('auto') solve; with
``--device cpu`` in f64 on the host LU, as the JAX package's example does.
"""

import argparse
import logging
from pathlib import Path

import numpy as np

import flowcontrol_tpu_torch.utils.lticontrol as ltc
from flowcontrol_tpu_torch.core.controller import Controller, stack_controllers
from flowcontrol_tpu_torch.core.operatorgetter import OperatorGetter
from flowcontrol_tpu_torch.examples.compute_operators import COARSE
from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver
from flowcontrol_tpu_torch.utils.linalg import get_mat_vp_shift_invert


def reduced_model(fs, n_modes=8, sigma=0.1 + 0.8j):
    """Petrov-Galerkin modal reduction of (E, A, B, C) onto leading modes."""
    og = OperatorGetter(fs)
    a, e, b, c = og.get_all(autodiff=False)
    vals, v = get_mat_vp_shift_invert(a, e, n=n_modes, sigma=sigma)
    vals_l, w = get_mat_vp_shift_invert(
        a.T.tocsr(), e.T.tocsr(), n=n_modes, sigma=np.conj(sigma)
    )
    # bi-orthogonalize: W^H E V = I
    g = w.conj().T @ (e @ v)
    w = w @ np.linalg.inv(g).conj().T
    ar = w.conj().T @ (a @ v)
    br = w.conj().T @ b
    cr = c @ v
    # realify (conjugate-pair modes): keep real part of the similarity
    ar_r = np.real(np.block([[ar.real, -ar.imag], [ar.imag, ar.real]]))
    br_r = np.vstack([br.real, br.imag])
    cr_r = np.hstack([cr.real, -cr.imag])
    return ltc.ss(ar_r, br_r, cr_r, np.zeros((cr_r.shape[0], br_r.shape[1])))


def lqg_population_cost(roll, carry0, y0, rom, dt: float, dtype=np.float32):
    """``cost(thetas (B, 4)) -> (B,)`` for a population search over the LQG
    weights (``utils.optim_algs.minimize(..., "pop", batch_costfun=cost)``;
    beyond the JAX package's example, which scores a fixed grid).

    Row i of ``thetas`` is log10 of (qx, ru, qw, rv): ``lqg_regulator(rom,
    *10**thetas[i])``. The B controllers are stacked (``stack_controllers``,
    ZOH at ``dt`` in ``dtype``) and stepped with B plant copies in one
    closed-loop rollout, ``roll(carry0, k_mats, y0)`` (a
    ``Stepper.closed_loop_fn``, whose sign the caller chooses), every member
    from the batched carry ``carry0`` and first measurement ``y0``. A
    member's cost is ∫Σy² dt + ∫‖u‖² dt (``compute_signal_cost`` and
    ``compute_control_cost``). A candidate whose Riccati solve fails scores
    +inf and keeps its slot with a zero controller of the ROM's order, so
    the stack's shape, and with it the rollout's CUDA graph, stays the
    same; a member that diverges or is not finite scores +inf too."""
    from flowcontrol_tpu_torch.utils.optim import compute_control_cost, compute_signal_cost

    n, m, p = rom.nstates, rom.ninputs, rom.noutputs
    zero = Controller(np.zeros((n, n)), np.zeros((n, p)), np.zeros((m, n)), np.zeros((m, p)))

    def cost(thetas):
        controllers, failed = [], []
        for theta in np.atleast_2d(thetas):
            try:
                k, _, _ = ltc.lqg_regulator(rom, *(10.0 ** theta))
                controllers.append(Controller(k.A, k.B, k.C, k.D))
                failed.append(False)
            except (np.linalg.LinAlgError, ValueError):
                controllers.append(zero)
                failed.append(True)
        _, (ys, _, us, div) = roll(carry0, stack_controllers(controllers, dt, dtype=dtype), y0)
        ys, us = ys.double().cpu().numpy(), us.double().cpu().numpy()
        costs = np.array([
            compute_signal_cost((ys[:, i] ** 2).sum(-1), dt, "integral")
            + compute_control_cost(us[:, i], dt) for i in range(ys.shape[1])
        ])
        bad = np.asarray(failed) | div.any(0).cpu().numpy() | ~np.isfinite(costs)
        return np.where(bad, np.inf, costs)

    return cost


def main(num_steps=60, device="cuda"):
    on_cpu = device == "cpu"
    fs = CylinderFlowSolver.make_default(
        Re=100, num_steps=num_steps, verbose=0, device=device, mesh_kwargs=COARSE,
        path_out=Path.cwd() / "data_output_synth",
        **({"solver_backend": "host_lu", "precision": "f64"} if on_cpu else {}),
    )
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=3)
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="newton",
                            initial_guess=fs.fields.UP0)

    rom = reduced_model(fs, n_modes=4)
    print("ROM:", rom, "stable:", ltc.isstable(rom))

    # LQG candidates over a small weight grid — MIMO (2 actuators, 3 sensors)
    candidates = []
    for qx in (0.1, 1.0, 10.0):
        k, _, _ = ltc.lqg_regulator(rom, qx, 1.0, 1.0, 1.0)
        candidates.append(Controller(k.A, k.B, k.C, k.D))
    dt = fs.params_time.dt

    fs.initialize_time_stepping()
    st = fs.stepper
    # feedback_sign=-1.0 is the JAX package's example's, kept as it is. It
    # is at fault (ROADMAP.md, "Faults in the reference"): lqg_regulator's
    # compensator takes +y (its input matrix is the Kalman gain), and the
    # rollout feeds it sign * y. On the reduced model every candidate's
    # closed loop is stable with +1 and unstable with -1, here and at the
    # default mesh's 56,383 dofs (chip_smoke.py phase 37), whose search
    # (phase 39) runs with +1.
    roll = st.make_rollout_closed_loop(num_steps, feedback_sign=-1.0)

    # batched evaluation: stack same-order controllers, one batched rollout
    k_stack = stack_controllers(candidates, dt, dtype=np.float64)
    n_cand = k_stack[0].shape[0]
    up0 = fs._carry.u_n.double().cpu().numpy()
    carry_b = st.init_carry(np.repeat(up0[None, :], n_cand, 0))
    y0_b = np.repeat(np.asarray(fs.y_meas)[None, :], n_cand, 0)
    _, (ys, des, us, div) = roll(carry_b, k_stack, y0_b)
    costs = des[-1].double().cpu().numpy()  # terminal perturbation energy per candidate
    print("terminal dE per candidate:", costs)
    print(f"best candidate: #{int(np.argmin(costs))}")
    return costs


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(num_steps=args.steps, device=args.device)
