"""Kernel S's host side and plain versions, on the CPU.

- ``csr_to_device`` ships no stored zeros, and on the coarse cylinder the
  zero-free mass (f32, f64) and BDF2 operator (f64) give, through S's
  wrapper (on the CPU its plain version), results ``torch.equal`` to the
  zero-keeping matrices' on a seeded batch (the single vector's
  ``torch.mv`` splits its sums by the row's length, so it is not held
  bitwise).
- ``SpmmPlan`` covers every nonzero of every row exactly once, in CSR
  order: the tiles cut the rows into consecutive runs of at most
  ``TILE_ROWS``, each tile's sorted column list holds exactly the columns
  its rows use and stays within the budget, and each nonzero's local index
  names its own column. On the coarse cylinder and cavity meshes (mass and
  operator) and on a random matrix with one row dense enough to force a
  split; a row past the budget takes a tile of its own.
- ``csr_residual``'s plain version is ``torch.equal`` to the composition
  ``(b.double() - csr_matmul(a, x.double())).to(float32)`` and launches
  nothing, and the Stepper's refinement solve (the first sweep through it)
  gives the bits of the composition it replaced.

The kernels themselves are held to these on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from flowcontrol_tpu_torch.core.stepper import csr_to_device, sparse_matvec, sparse_residual
from flowcontrol_tpu_torch.fem.assembly import to_scipy_csr
from flowcontrol_tpu_torch.mesh.generation import cavity_mesh, cylinder_mesh
from flowcontrol_tpu_torch.models.cavity import CavityFlowSolver
from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver
from flowcontrol_tpu_torch.ops.spmm import (
    TILE_COLS,
    TILE_ROWS,
    SpmmPlan,
    csr_matmul,
    csr_matmul_plain,
    csr_residual,
    csr_residual_plain,
)

torch.set_num_threads(1)

# the reference's coarse meshes (tests/integration/conftest.py)
COARSE = dict(yinf=5.0, xinf=15.0, xinfa=-5.0, n1=4.0, n2=2.0, n3=0.8, segments=80)
FLOWS = {"cylinder": lambda: CylinderFlowSolver.make_default(mesh=cylinder_mesh(**COARSE),
                                                             device="cpu"),
         "cavity": lambda: CavityFlowSolver.make_default(
             mesh=cavity_mesh(n_coarse=12, n_mid=25, n_fine=50), device="cpu")}


@pytest.fixture(scope="module")
def matrices():
    """Each coarse flow's assembled mass and BDF2 operator (a seeded base
    flow), as scipy CSR with the assembly's stored zeros."""
    out = {}
    for name, make in FLOWS.items():
        fs = make()
        space, forms = fs.space, fs.forms
        u0 = np.random.default_rng(0).standard_normal((space.n_vnodes, 2))
        out[name] = {
            "mass": to_scipy_csr(forms.mass_elements(), space.cell_dofs, space.n_dofs),
            "operator": to_scipy_csr(forms.transient_lhs(2, u0), space.cell_dofs,
                                     space.n_dofs),
        }
    return out


def _zero_keeping(a_csr, dtype) -> torch.Tensor:
    """The scipy matrix as torch sparse CSR with every stored entry."""
    a = a_csr.tocsr()
    return torch.sparse_csr_tensor(torch.as_tensor(a.indptr.astype(np.int64)),
                                   torch.as_tensor(a.indices.astype(np.int64)),
                                   torch.as_tensor(a.data, dtype=dtype), size=a.shape,
                                   check_invariants=True)


@pytest.mark.parametrize("which", ["mass", "operator"])
def test_torch_csr_to_device_stores_no_zeros(matrices, which):
    a_csr = matrices["cylinder"][which]
    stored, nonzero = a_csr.nnz, int(np.count_nonzero(a_csr.data))
    t = csr_to_device(a_csr, "cpu", torch.float64)
    assert bool((t.values() != 0).all())
    assert t.values().numel() == nonzero < stored  # the assembly stores zeros
    assert a_csr.nnz == stored  # the caller's matrix keeps them
    assert not hasattr(t, "spmm_plan")  # the plan is built for the card only
    dense = torch.as_tensor(a_csr.toarray())
    assert torch.equal(t.to_dense(), dense)


@pytest.mark.parametrize("which,dtype", [("mass", torch.float32), ("mass", torch.float64),
                                         ("operator", torch.float64)])
def test_torch_zero_free_matrix_gives_the_same_bits(matrices, which, dtype):
    """An FMA with a stored 0 leaves every sum's value: the zero-free
    matrix's products equal the zero-keeping matrix's."""
    a_csr = matrices["cylinder"][which]
    x = torch.as_tensor(np.random.default_rng(7).standard_normal((5, a_csr.shape[1])),
                        dtype=dtype)
    kept, free = _zero_keeping(a_csr, dtype), csr_to_device(a_csr, "cpu", dtype)
    assert torch.equal(csr_matmul(free, x), csr_matmul(kept, x))


def _check_plan(plan: SpmmPlan, a_csr, max_cols: int) -> None:
    """Every nonzero of every row once, in CSR order; the budget kept."""
    indptr, indices = a_csr.indptr.astype(np.int64), a_csr.indices.astype(np.int64)
    row0, off = plan.tile_row0.numpy(), plan.col_off.numpy()
    cols, loc = plan.cols.numpy(), plan.loc.numpy().astype(np.int64)
    assert loc.shape == indices.shape
    words = plan.entries.numpy()[:, :plan.entries.shape[1] // 2].copy()
    assert np.array_equal(words.view(a_csr.dtype).ravel(), a_csr.data)  # the values, bitwise
    assert np.array_equal(plan.indptr.numpy(), indptr)
    rows = np.diff(row0)
    assert row0[0] == 0 and row0[-1] == a_csr.shape[0]
    assert rows.min() >= 1 and rows.max() <= TILE_ROWS
    assert plan.max_cols == np.diff(off).max() <= max_cols
    assert off[0] == 0 and off[-1] == cols.shape[0] == plan.staged_cols
    for t in range(plan.n_tiles):
        c = cols[off[t]:off[t + 1]]
        k0, k1 = indptr[row0[t]], indptr[row0[t + 1]]
        assert np.array_equal(c, np.unique(indices[k0:k1]))  # sorted, each used column once
        assert np.array_equal(c[loc[k0:k1]], indices[k0:k1])  # each nonzero its own column


@pytest.mark.parametrize("which", ["mass", "operator"])
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_torch_spmm_plan_covers_every_nonzero(matrices, flow, which):
    a_csr = matrices[flow][which].copy()
    a_csr.eliminate_zeros()
    plan = SpmmPlan.build(a_csr.indptr, a_csr.indices, a_csr.data, "cpu")
    _check_plan(plan, a_csr, TILE_COLS)
    # 64 rows of the mesh's matrices use more columns than the budget: the
    # plan cuts their tiles by rows
    assert plan.n_tiles > -(-a_csr.shape[0] // TILE_ROWS)
    # the f32 values pack into 8-byte entries over the same tiles
    f32 = SpmmPlan.build(a_csr.indptr, a_csr.indices, a_csr.data.astype(np.float32), "cpu")
    _check_plan(f32, a_csr.astype(np.float32), TILE_COLS)
    assert f32.entries.shape[1] == 2 and plan.entries.shape[1] == 4
    assert torch.equal(f32.tile_row0, plan.tile_row0) and torch.equal(f32.cols, plan.cols)


def _forced_split(seed: int = 0, dense: int = 100):
    """A random 1,000 x 3,000 matrix, ~8 nonzeros a row, whose row 300 holds
    ``dense`` distinct columns: its tile overflows the budget of TILE_COLS
    (past TILE_COLS, the row alone does)."""
    rng = np.random.default_rng(seed)
    a = sp.random(1000, 3000, density=8 / 3000, format="lil", random_state=rng)
    a[300, rng.choice(3000, dense, replace=False)] = rng.standard_normal(dense)
    a = a.tocsr()
    a.sort_indices()
    return a


def test_torch_spmm_plan_cuts_a_dense_row_tile():
    a_csr = _forced_split()
    plan = SpmmPlan.build(a_csr.indptr, a_csr.indices, a_csr.data, "cpu")
    _check_plan(plan, a_csr, TILE_COLS)
    rows = np.diff(plan.tile_row0.numpy())
    assert plan.n_tiles > -(-1000 // TILE_ROWS) and (rows[:-1] < TILE_ROWS).any()
    # a row with more distinct columns than the budget takes a tile alone
    a_csr = _forced_split(dense=200)
    dense = np.unique(a_csr.indices[a_csr.indptr[300]:a_csr.indptr[301]]).size
    alone = SpmmPlan.build(a_csr.indptr, a_csr.indices, a_csr.data, "cpu")
    _check_plan(alone, a_csr, dense)
    row0 = alone.tile_row0.numpy()
    t = int(np.searchsorted(row0, 300, side="right")) - 1
    assert row0[t] == 300 and row0[t + 1] == 301 and alone.max_cols == dense > TILE_COLS
    assert np.diff(alone.col_off.numpy())[np.arange(alone.n_tiles) != t].max() <= TILE_COLS


@pytest.mark.parametrize("batch", [1, 3, 33])
def test_torch_csr_residual_plain_is_the_composition(matrices, batch):
    a_csr = matrices["cylinder"]["operator"]
    a64 = csr_to_device(a_csr, "cpu", torch.float64)
    rng = np.random.default_rng(batch)
    x = torch.as_tensor(rng.standard_normal((batch, a_csr.shape[1])), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((batch, a_csr.shape[0])), dtype=torch.float32)
    before = csr_residual.launches
    r = csr_residual(a64, b, x)
    assert csr_residual.launches == before  # the plain version launches nothing
    want = (b.double() - csr_matmul(a64, x.double())).to(torch.float32)
    assert r.dtype == torch.float32 and torch.equal(r, want)
    assert torch.equal(csr_residual_plain(a64, b, x), want)
    assert torch.equal(sparse_residual(a64, b, x), want)
    assert torch.equal(sparse_residual(a64, b[0], x[0]),
                       (b[0].double() - torch.mv(a64, x[0].double())).to(torch.float32))
    assert torch.equal(csr_matmul_plain(a64, x.double()), csr_matmul(a64, x.double()))


@pytest.fixture(scope="module")
def f32_stepper():
    """The coarse cylinder's f32 Stepper (dense LU) on a zero base flow."""
    fs = CylinderFlowSolver.make_default(mesh=cylinder_mesh(**COARSE), precision="f32",
                                         device="cpu")
    space = fs.space
    fs._assign_steady_state(np.zeros((space.n_vnodes, 2)), np.zeros(space.n_pressure_dofs))
    fs.initialize_time_stepping()
    fs._prepare_systems()
    return fs._stepper


@pytest.mark.parametrize("batch", [(), (3,)])
def test_torch_refinement_sweep_gives_the_composition(f32_stepper, batch):
    """The Stepper's f32 solve with its refinement sweep (the first sweep's
    residual through ``sparse_residual``) gives the bits of the composition
    ``(rhs.double() - A x.double()).to(float32)`` it replaced; the device
    matrices store no zeros."""
    st = f32_stepper
    oi = st._order_idx[2]
    assert st.dtype == torch.float32 and st._refine[oi] == 1
    for a in (st._dev["m"], st._dev["a_refine"][oi]):
        assert bool((a.values() != 0).all())
    rhs = torch.as_tensor(np.random.default_rng(4).standard_normal(batch + (st.space.n_dofs,)),
                          dtype=torch.float32)
    x = st._solve_once(oi, rhs)
    x64 = x.double()
    r = (rhs.double() - sparse_matvec(st._dev["a_refine"][oi], x64)).to(torch.float32)
    want = (x64 + st._solve_once(oi, r).double()).to(torch.float32)
    assert torch.equal(st._solve(2, rhs), want)
