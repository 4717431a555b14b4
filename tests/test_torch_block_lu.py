"""The port's blocked LU against the JAX package's, factor by factor.

The cases of ``tests/test_block_lu.py`` (random, batched, padding with
n % bs != 0, the saddle structure of the time-step matrix) go through both
``BlockLU`` classes in float64 on the CPU from one seeded numpy matrix:
``lu`` and ``dinv`` agree to 1e-10 relative (the two packages invert the
diagonal blocks with different LAPACK routines and sum the trailing updates
in another order), and the port's solve meets the residuals the JAX tests
ask for. ``block_lu_from_numpy`` carries a JAX factor across unchanged, and
a sparse input gives the dense input's factor.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from flowcontrol_tpu.solvers.block_lu import BlockLU as BlockLUJ
from flowcontrol_tpu_torch.solvers.block_lu import BlockLU as BlockLUT
from flowcontrol_tpu_torch.solvers.block_lu import block_lu_from_numpy, block_lu_solve

torch.set_num_threads(1)

TOL = 1e-10


def _saddle_matrix():
    """The BDF2 time-step matrix of a small unit square, velocity first,
    identity rows at the constrained dofs (tests/test_block_lu.py)."""
    from flowcontrol_tpu_torch.core.nsforms import NSForms
    from flowcontrol_tpu_torch.fem.assembly import CellGeometry, to_scipy_csr
    from flowcontrol_tpu_torch.fem.bc import BCSet, DirichletBC
    from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace
    from flowcontrol_tpu_torch.mesh.generation import unit_square_mesh

    mesh = unit_square_mesh(8)
    space = TaylorHoodSpace.build(mesh)
    forms = NSForms(space=space, geom=CellGeometry(space), Re=100.0, dt=0.005)
    u0 = np.zeros((space.n_vnodes, 2))
    u0[:, 0] = 1.0
    a_csr = to_scipy_csr(forms.transient_lhs(2, u0), space.cell_dofs, space.n_dofs)
    bnodes = space.boundary_vel_nodes(np.arange(mesh.boundary_facets.shape[0]))
    bcs = BCSet(
        [DirichletBC(dofs=np.concatenate([2 * bnodes, 2 * bnodes + 1]), values=0.0),
         DirichletBC(dofs=np.array([2 * space.n_vnodes]), values=0.0)],
        space.n_dofs,
    )
    a_bc, _ = bcs.eliminate_csr(a_csr)
    return np.asarray(a_bc.todense())


def _case(name):
    """(a, b, bs, residual tolerance) as tests/test_block_lu.py builds them."""
    if name == "random":
        rng = np.random.default_rng(0)
        n = 300
        return np.eye(n) * 3 + 0.5 * rng.standard_normal((n, n)), rng.standard_normal(n), 64, 1e-10
    if name == "batched":
        rng = np.random.default_rng(1)
        n = 200
        return (np.eye(n) * 2 + 0.3 * rng.standard_normal((n, n)),
                rng.standard_normal((5, n)), 64, 1e-9)
    if name == "padding":
        rng = np.random.default_rng(2)
        n = 173
        return np.eye(n) * 4 + 0.2 * rng.standard_normal((n, n)), rng.standard_normal(n), 64, 1e-10
    a = _saddle_matrix()
    return a, np.random.default_rng(3).standard_normal(a.shape[0]), 128, 1e-8


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("name", ["random", "batched", "padding", "saddle"])
def test_torch_block_lu_matches_jax(name):
    a, b, bs, res_tol = _case(name)
    fj = BlockLUJ(a, bs=bs, dtype=np.float64)
    ft = BlockLUT(a, bs=bs, dtype=torch.float64, device="cpu")
    assert (ft.n, ft.n_pad, ft.nb, ft.bs) == (fj.n, fj.n_pad, fj.nb, bs)
    assert ft.lu.dtype == torch.float64 and ft.lu.shape == (fj.n_pad, fj.n_pad)
    assert _rel(ft.lu.numpy(), fj.lu) <= TOL
    assert _rel(ft.dinv.numpy(), fj.dinv) <= TOL
    x = ft.solve(torch.as_tensor(b)).numpy()
    assert x.shape == b.shape
    for xk, bk in zip(np.atleast_2d(x), np.atleast_2d(b)):
        assert np.linalg.norm(a @ xk - bk) / np.linalg.norm(bk) < res_tol
    assert _rel(x, fj.solve(b)) <= TOL


@pytest.mark.parametrize("name", ["batched", "padding"])
def test_torch_block_lu_from_numpy_round_trip(name):
    """A JAX factor carried across is the same factor: the arrays come back
    bitwise, and the port's solve on it equals the JAX solve (to 1e-10:
    these matrices are not diagonally dominant)."""
    a, b, bs, _ = _case(name)
    fj = BlockLUJ(a, bs=bs, dtype=np.float64)
    lu, dinv = np.asarray(fj.lu), np.asarray(fj.dinv)
    ft = block_lu_from_numpy(lu, dinv, bs, fj.n, "cpu", torch.float64)
    assert np.array_equal(ft.lu.numpy(), lu) and np.array_equal(ft.dinv.numpy(), dinv)
    assert (ft.n, ft.n_pad, ft.nb) == (fj.n, fj.n_pad, fj.nb)
    x = block_lu_solve(ft.tree(), torch.as_tensor(b), bs=bs, n=fj.n).numpy()
    assert _rel(x, fj.solve(b)) <= TOL
    with pytest.raises(ValueError):
        block_lu_from_numpy(lu, dinv, bs, fj.n_pad + 1, "cpu", torch.float64)
    with pytest.raises(ValueError):
        block_lu_from_numpy(lu, dinv[:-1], bs, fj.n, "cpu", torch.float64)


@pytest.mark.parametrize("n", [173, 128])
def test_torch_block_lu_sparse_input_gives_dense_factor(n):
    """A scipy sparse input is densified on the device from its triplets
    (identity on the padding rows): bitwise the dense input's factor."""
    rng = np.random.default_rng(4)
    a = sp.random(n, n, density=0.05, random_state=5, format="csr") + 4.0 * sp.eye(n)
    fd = BlockLUT(np.asarray(a.todense()), bs=64, dtype=torch.float64, device="cpu")
    fs = BlockLUT(a.tocsr(), bs=64, dtype=torch.float64, device="cpu")
    assert torch.equal(fs.lu, fd.lu) and torch.equal(fs.dinv, fd.dinv)
    b = rng.standard_normal((2, n))
    x = fs.solve(torch.as_tensor(b)).numpy()
    assert np.linalg.norm(a @ x.T - b.T) / np.linalg.norm(b) < 1e-12


def test_torch_block_lu_store_dtype_and_errors():
    """The factor is computed in ``dtype`` and stored in ``store_dtype``;
    a singular diagonal block and a non-square input are refused."""
    a, b, bs, _ = _case("padding")
    f64 = BlockLUT(a, bs=bs, dtype=torch.float64, device="cpu")
    f32 = BlockLUT(a, bs=bs, dtype=torch.float64, store_dtype=torch.float32, device="cpu")
    assert f32.lu.dtype == torch.float32 and f32.dinv.dtype == torch.float32
    assert torch.equal(f32.lu, f64.lu.float())  # rounded once, after the elimination
    x = f32.solve(torch.as_tensor(b, dtype=torch.float32))
    assert x.dtype == torch.float32
    assert _rel(x.numpy(), f64.solve(torch.as_tensor(b)).numpy()) <= 1e-5
    with pytest.raises(torch.linalg.LinAlgError):
        BlockLUT(np.zeros((64, 64)), bs=64, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError):
        BlockLUT(np.zeros((64, 32)), bs=64, dtype=torch.float64, device="cpu")
