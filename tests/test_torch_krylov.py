"""The port's Krylov backend and the step's measured residual against the
JAX package's, in float64 on the CPU.

Inputs: the JAX package's own fixture (``tests/test_stepper.py``): the lid
cavity at ``n_mesh=12`` (2,715 dofs, its pressure pin among the BC dofs),
Re=500, its base flow from Picard (4) and Newton (10) on the host, computed
once by the JAX package; random vectors from ``numpy.random.default_rng``.

- The BDF2 operator (the BC-eliminated CSR ``a_bc`` on the device) and the
  SIMPLE preconditioner's apply, for (n,) and (2, n), against the JAX
  package's ``MatFreeOperator`` and ``SimplePreconditioner`` (1e-12 of the
  largest entry): the two applies differ only in summation order.
- The port's ``gmres`` and ``bicgstab`` against ``jax.scipy``'s at
  ``restart=5`` with ``maxiter=1`` and ``maxiter=3`` (BiCGStab: 1 and 3
  iterations), for (n,) and (2, n), with the SIMPLE preconditioner as ``M``
  and a random start: 1e-11 relative (measured: 2.5e-12 for GMRES at (n,)
  and one restart, whose least squares go through the normal equations;
  3.4e-13 at most otherwise); ``fgmres`` against the JAX package's (1e-12).
- The JAX package's stepper test: 5 steps on each Krylov backend, the port
  against the JAX package's same backend (1e-8 relative) and against the
  port's host LU (1e-7 absolute, the JAX test's); ``last_solve_res`` at most
  ``krylov_rtol`` on GMRES, below 1e-9 on the dense LU with
  ``measure_residual=True`` and -1.0 without.
- A B = 2 open-loop rollout on GMRES (``gmres_iters=5``, two cycles at
  most: unconverged, so the joint inner products show) equal to the JAX
  package's B = 2 rollout (1e-8), with member 0 off its own single stream by
  more than round-off in both packages: a batched Krylov solve is one solve
  of the block-diagonal system.
- On the Krylov backend ``compiled_step`` and ``rollout_open_loop`` equal
  eager ``Stepper.step`` calls bitwise.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp
from jax.scipy.sparse.linalg import bicgstab as bicgstab_j
from jax.scipy.sparse.linalg import gmres as gmres_j

from flowcontrol_tpu.models.lidcavity import LidCavityFlowSolver as LidJ
from flowcontrol_tpu.solvers import krylov as krylov_j
from flowcontrol_tpu_torch.models.lidcavity import LidCavityFlowSolver as LidT
from flowcontrol_tpu_torch.solvers import krylov as krylov_t

torch.set_num_threads(1)

STEPS = 5
KRYLOV_TOL = 1e-12
#: the Krylov solves against jax.scipy's: measured here 2.5e-12 for GMRES
#: at (n,) and maxiter=1 (its least squares go through the normal
#: equations, which square H's condition number), 3.4e-13 at most otherwise
SOLVE_TOL = 1e-11
SMALL_KRYLOV = {"gmres_iters": 5, "krylov_max_cycles": 2}


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS thread (the factorizations' and SIMPLE's dense algebra), as
    torch gets one: the suite runs beside other test workers, and spinning
    BLAS threads of several processes on the same cores slow each other
    many times over."""
    with threadpool_limits(limits=1):
        yield


def _make(cls, tmp_path, backend, **kw):
    extra = {} if cls is LidJ else {"device": "cpu"}
    return cls.make_default(Re=500, num_steps=10, verbose=0, n_mesh=12, path_out=tmp_path,
                            solver_backend=backend, precision="f64", **extra, **kw)


def _run(fs, base, n=STEPS):
    fs._assign_steady_state(*base)
    fs.initialize_time_stepping()
    for _ in range(n):
        fs.step(np.zeros(1))
    return np.asarray(fs.fields.up_, dtype=float)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def lid_base(tmp_path_factory):
    fs = _make(LidJ, tmp_path_factory.mktemp("base"), "host_lu")
    fs.compute_steady_state(u_ctrl=[0.0], method="picard", max_iter=4)
    fs.compute_steady_state(u_ctrl=[0.0], method="newton", initial_guess=fs.fields.UP0,
                            max_iter=10)
    return fs.fields.U0.copy(), fs.fields.P0.copy()


@pytest.fixture(scope="module")
def runs(lid_base, tmp_path_factory):
    """{(package, backend): (solver, final mixed state)} after STEPS steps."""
    out = {}
    for pkg, cls in (("jax", LidJ), ("torch", LidT)):
        for backend in ("gmres", "bicgstab"):
            fs = _make(cls, tmp_path_factory.mktemp(f"{pkg}{backend}"), backend)
            out[pkg, backend] = (fs, _run(fs, lid_base))
    fs = _make(LidT, tmp_path_factory.mktemp("host"), "host_lu")
    out["torch", "host_lu"] = (fs, _run(fs, lid_base))
    return out


def _ops(runs):
    """(JAX (op, pc), port (op, pc)) of the BDF2 system."""
    st_j, st_t = runs["jax", "gmres"][0].stepper, runs["torch", "gmres"][0].stepper
    return (st_j._dev["solvers"][st_j._order_idx[2]], st_t._solvers[st_t._order_idx[2]])


def _vectors(n, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape + (n,))


@pytest.mark.parametrize("shape", [(), (2,)])
def test_torch_krylov_operator_and_simple_match_jax(runs, shape):
    (op_j, pc_j), (op_t, pc_t) = _ops(runs)
    x = _vectors(op_t.a.shape[0], shape, 0)
    for fj, ft in ((op_j.apply, op_t.apply), (pc_j.apply, pc_t.apply)):
        want = np.asarray(fj(jnp.asarray(x)))
        got = ft(torch.as_tensor(x)).numpy()
        assert got.dtype == np.float64 and got.shape == x.shape
        assert _rel(got, want) <= KRYLOV_TOL
    assert pc_t.s_inv.shape == tuple(np.asarray(pc_j.s_inv).shape)
    assert np.array_equal(pc_t.vel_mask.numpy(), np.asarray(pc_j.vel_mask))


@pytest.mark.parametrize("maxiter", [1, 3])
@pytest.mark.parametrize("shape", [(), (2,)])
@pytest.mark.parametrize("method", ["gmres", "bicgstab"])
def test_torch_krylov_matches_jax_scipy(runs, method, shape, maxiter):
    (op_j, pc_j), (op_t, pc_t) = _ops(runs)
    n = op_t.a.shape[0]
    b, x0 = _vectors(n, shape, 1), 0.1 * _vectors(n, shape, 2)
    if method == "gmres":
        want, _ = gmres_j(op_j.apply, jnp.asarray(b), x0=jnp.asarray(x0), M=pc_j.apply,
                          tol=0.0, restart=5, maxiter=maxiter, solve_method="batched")
        got, info = krylov_t.gmres(op_t.apply, torch.as_tensor(b), x0=torch.as_tensor(x0),
                                   M=pc_t.apply, tol=0.0, restart=5, maxiter=maxiter)
        assert int(info) == 0
    else:
        want, _ = bicgstab_j(op_j.apply, jnp.asarray(b), x0=jnp.asarray(x0), M=pc_j.apply,
                             tol=0.0, maxiter=maxiter)
        got, _ = krylov_t.bicgstab(op_t.apply, torch.as_tensor(b), x0=torch.as_tensor(x0),
                                   M=pc_t.apply, tol=0.0, maxiter=maxiter)
    want = np.asarray(want)
    assert want.dtype == np.float64 and not np.allclose(want, x0)  # the solve moved x
    assert _rel(got.numpy(), want) <= SOLVE_TOL


def test_torch_fgmres_matches_jax(runs):
    (op_j, pc_j), (op_t, pc_t) = _ops(runs)
    n = op_t.a.shape[0]
    b = _vectors(n, (), 3)
    want = krylov_j.fgmres_restarted(op_j.apply, pc_j.apply, jnp.asarray(b), jnp.zeros(n), 6, 2)
    got = krylov_t.fgmres_restarted(op_t.apply, pc_t.apply, torch.as_tensor(b),
                                    torch.zeros(n, dtype=torch.float64), 6, 2)
    assert _rel(got.numpy(), np.asarray(want)) <= KRYLOV_TOL


@pytest.mark.parametrize("backend", ["gmres", "bicgstab"])
def test_torch_krylov_steps_match_jax(runs, backend):
    fs_j, x_j = runs["jax", backend]
    fs_t, x_t = runs["torch", backend]
    _, x_host = runs["torch", "host_lu"]
    assert fs_t.stepper._solver_kinds == [backend, backend]
    assert _rel(x_t, x_j) <= 1e-8
    assert np.allclose(x_t, x_host, atol=1e-7)
    assert fs_t.last_solve_res >= 0.0
    if backend == "gmres":  # tests/test_stepper.py's check
        assert fs_j.last_solve_res <= fs_j.stepper.krylov_rtol
        assert fs_t.last_solve_res <= fs_t.stepper.krylov_rtol


def test_torch_direct_residual_on_request(lid_base, tmp_path):
    fs = _make(LidT, tmp_path / "dr", "dense_lu", stepper_options={"measure_residual": True})
    _run(fs, lid_base, n=3)
    assert 0.0 <= fs.last_solve_res < 1e-9  # f64 direct solve
    fs = _make(LidT, tmp_path / "nr", "dense_lu")
    _run(fs, lid_base, n=1)
    assert fs.last_solve_res == -1.0  # not measured by default


def _batch(lid_base, tmp_path):
    """Two distinct states (the base flow's perturbation, scaled) and
    controls for a B = 2 rollout, and each package's GMRES solver."""
    solvers = {}
    for pkg, cls in (("jax", LidJ), ("torch", LidT)):
        fs = _make(cls, tmp_path / pkg, "gmres", stepper_options=dict(SMALL_KRYLOV))
        fs._assign_steady_state(*lid_base)
        fs.initialize_time_stepping()
        solvers[pkg] = fs
    n = solvers["torch"].space.n_dofs
    rng = np.random.default_rng(4)
    up = 1e-3 * rng.standard_normal((2, n))
    u_seq = np.stack([np.linspace(0.02, 0.04, 2)[:, None]] * 3)  # (3, 2, 1)
    return solvers, up, u_seq


def test_torch_krylov_batch_is_one_system(lid_base, tmp_path):
    solvers, up, u_seq = _batch(lid_base, tmp_path)
    outs = {}
    for pkg, fs in solvers.items():
        st = fs.stepper
        carry, out = st.rollout_open_loop(st.init_carry(up), u_seq)
        single, _ = st.rollout_open_loop(st.init_carry(up[0]), u_seq[:, 0])
        outs[pkg] = [np.asarray(v, dtype=float) for v in (carry.u_n, single.u_n, out.y)]
    (xj, sj, yj), (xt, st_, yt) = outs["jax"], outs["torch"]
    assert _rel(xt, xj) <= 1e-8 and _rel(yt, yj) <= 1e-8
    for x, s in ((xj, sj), (xt, st_)):
        assert _rel(x[0], s) > 1e-10  # the joint batch: member 0 is not its own stream


def test_torch_krylov_compiled_equals_eager(lid_base, tmp_path):
    solvers, up, u_seq = _batch(lid_base, tmp_path)
    st = solvers["torch"].stepper
    assert st._krylov and st.compiled_step() == st.step
    carry = st.init_carry(up)
    outs = []
    for t in range(len(u_seq)):
        carry, out = st.step(carry, u_seq[t])
        outs.append(out)
    rolled, out_r = st.rollout_open_loop(st.init_carry(up), u_seq)
    assert torch.equal(rolled.u_n, carry.u_n) and torch.equal(rolled.mu_n, carry.mu_n)
    assert torch.equal(out_r.y, torch.stack([o.y for o in outs]))
    assert torch.equal(out_r.res, torch.stack([o.res for o in outs]))
    assert bool((out_r.res > 0).all())
    assert all(not p.graphed for p in st._programs.values())
