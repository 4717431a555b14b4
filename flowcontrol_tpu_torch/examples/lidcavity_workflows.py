"""Lid-driven cavity workflows: Re continuation, batched ICs, eigenvalues.

    python -m flowcontrol_tpu_torch.examples.lidcavity_workflows [--device cpu]

The port's copy of ``examples/lidcavity_workflows.py`` (ref:
src/examples/lidcavity/{compute_steady_state_increasing_Re,
batch_run_lidcavity, eig_compute_lidcavity}.py): Newton continuation in Re
on the host, one batched rollout of perturbed initial conditions (the
reference loops over separate runs; here B states step together, on the
card unless ``device="cpu"``), and the leading eigenvalues of the
linearized operator (host ARPACK shift-invert).
"""

import argparse
import logging
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.models.lidcavity import LidCavityFlowSolver

logging.basicConfig(level=logging.INFO)
cwd = Path(__file__).parent


def steady_state_increasing_Re(res=(1000, 3000, 5000, 8000), n_mesh=32, device="cuda",
                               path_out=None):
    """Continuation in Re (ref: compute_steady_state_increasing_Re.py)."""
    guess = None
    flows = {}
    for re_k in res:
        fs = LidCavityFlowSolver.make_default(
            Re=re_k, num_steps=1, verbose=0, n_mesh=n_mesh, device=device,
            path_out=Path(path_out or Path.cwd() / "data_output_lidcavity"),
        )
        if guess is None:
            fs.compute_steady_state(u_ctrl=[0.0], method="picard", max_iter=5)
            guess = fs.fields.UP0
        fs.compute_steady_state(u_ctrl=[0.0], method="newton",
                                initial_guess=guess, max_iter=20)
        guess = fs.fields.UP0
        flows[re_k] = (fs.fields.U0.copy(), fs.fields.P0.copy())
        print(f"Re={re_k}: U0_max={np.abs(fs.fields.U0).max():.4f}")
    return fs, flows


def batch_run(fs, n_batch=8, num_steps=50):
    """Batched perturbed rollouts, one rollout of the whole batch
    (ref: batch_run_lidcavity.py runs a Python loop of separate sims)."""
    fs.initialize_time_stepping()
    st = fs.stepper
    rng = np.random.default_rng(0)
    up0 = fs._carry.u_n.double().cpu().numpy()
    batch = up0[None, :] + 1e-3 * rng.standard_normal((n_batch, up0.shape[0]))
    carry = st.init_carry(batch)
    u_seq = np.zeros((num_steps, n_batch, 1))
    _, outs = st.make_rollout_open_loop()(carry, u_seq)
    de = outs.dE.double().cpu().numpy()  # (T, B)
    print("final dE per batch member:", de[-1])
    return de


def eigenvalues(fs):
    """(ref: eig_compute_lidcavity.py)"""
    from flowcontrol_tpu_torch.core.operatorgetter import OperatorGetter
    from flowcontrol_tpu_torch.utils.linalg import get_mat_vp_shift_invert

    og = OperatorGetter(fs)
    a = og.get_A(autodiff=False)
    e = og.get_mass_matrix()
    vals, _ = get_mat_vp_shift_invert(a, e, n=6, sigma=0.0 + 0.5j)
    print("leading eigenvalues:", vals)
    return vals


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    fs, flows = steady_state_increasing_Re(res=(1000, 2000), device=args.device)
    batch_run(fs)
    eigenvalues(fs)
