"""The half-million-dof cylinder (``flowcontrol_tpu_torch/tools/scale_big.py``)
against the JAX package on the CPU.

- The tool's mesh (``build``) at densities 3 and 4 equals the JAX
  package's generator at the JAX tool's keywords (its ``tools/
  scale_big.py:37-44``), coordinates and cells bitwise: 8,136 and 12,638
  dofs.
- At density 30 the port's generator gives 506,553 dofs (449,988 velocity
  + 56,565 pressure), and ``committed_baseflow`` finds the committed file
  by its mesh's checksum.
- The tool's path at density 2 (4,287 dofs) in float64 against the JAX
  tool's: the base
  flow by each package's Picard 4 + Newton 8 (U0 and P0), then the set-up
  of the BDF2 system alone (order 2, ``force_substructure``: the
  multifrontal solve) and 5 steps of ``make_rollout_open_loop`` from a
  seeded state with seeded controls: y, dE and the field to 1e-10.
- The tool's ``factor`` (the host build ``chip_smoke.py`` runs beside its
  other phases) writes entries that the tool's set-up then streams
  (``loaded_from`` 'stream'), the factor the build reported.
- The committed 506,553-dof base flow's steady residual is the recipe's
  final Newton residual (``make_baseflow cylinder_big``'s last iterate).
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from flowcontrol_tpu.mesh.generation import cylinder_mesh as cylinder_mesh_j
from flowcontrol_tpu.models.cylinder import CylinderFlowSolver as CylJ
from flowcontrol_tpu_torch.core.stepper import carry_to_numpy
from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace
from flowcontrol_tpu_torch.models import make_baseflow
from flowcontrol_tpu_torch.models.baseflows import BASEFLOW_DIR, committed_baseflow, write_baseflow
from flowcontrol_tpu_torch.tools import scale_big

torch.set_num_threads(1)

TOL = 1e-10
STEPS = 5
MF = {"force_substructure": True}
DENSITY = 2.0  # the tool's path at 4,287 dofs
# the committed base flow's recipe (make_baseflow cylinder_big): its last
# Newton iterate's residual, as that run computed it
BIG_NEWTON_RES = 1.0032248060258008e-14


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module", autouse=True)
def _factor_cache_off():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", "off")
        yield


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _jax_kwargs(d: float) -> dict:
    """The JAX tool's mesh keywords (tools/scale_big.py:40-41)."""
    return dict(yinf=10.0, n1=d, n2=d / 2.0, n3=d / 5.5, segments=int(24 * d))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Both packages' tool solvers at DENSITY, f64, the multifrontal
    solve, each with its own Picard 4 + Newton 8 base flow."""
    ft = scale_big.build(DENSITY, "dense_lu", "f64", num_steps=STEPS, device="cpu",
                         path_out=tmp_path_factory.mktemp("t"), stepper_options=MF)
    make_baseflow.cylinder_big_steady(ft, [])
    fj = CylJ.make_default(Re=100, num_steps=STEPS, save_every=0, verbose=10,
                           path_out=tmp_path_factory.mktemp("j"), solver_backend="dense_lu",
                           precision="f64", mesh_kwargs=_jax_kwargs(DENSITY),
                           stepper_options=MF)
    fj.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=4)
    fj.compute_steady_state(u_ctrl=[0.0, 0.0], method="newton", max_iter=8,
                            initial_guess=fj.fields.UP0)
    return fj, ft


@pytest.fixture(scope="module")
def big(tmp_path_factory):
    """The tool's solver at the committed base flow's density (506,553
    dofs), host f64."""
    return scale_big.build(make_baseflow.CYLINDER_BIG_DENSITY, "host_lu", "f64", num_steps=1,
                           device="cpu", path_out=tmp_path_factory.mktemp("big"))


@pytest.mark.parametrize("density,dofs", [(3.0, 8_136), (4.0, 12_638)])
def test_torch_scale_big_mesh_matches_jax(density, dofs, tmp_path):
    mesh_t = scale_big.build(density, "host_lu", "f64", num_steps=1, device="cpu",
                             path_out=tmp_path).mesh
    mesh_j = cylinder_mesh_j(**_jax_kwargs(density))
    assert np.array_equal(mesh_t.coords, np.asarray(mesh_j.coords))
    assert np.array_equal(mesh_t.cells, np.asarray(mesh_j.cells))
    assert TaylorHoodSpace.build(mesh_t).n_dofs == dofs


def test_torch_scale_big_committed_baseflow_found(big):
    fs = big
    assert (fs.space.n_dofs, fs.space.n_vel_dofs, fs.space.n_pressure_dofs) == (
        506_553, 449_988, 56_565)
    assert committed_baseflow(fs) == BASEFLOW_DIR / "cylinder_re100_n506553.npz"


def test_torch_scale_big_path_matches_jax(pair):
    fj, ft = pair
    assert _rel(ft.fields.U0, fj.fields.U0) <= TOL and _rel(ft.fields.P0, fj.fields.P0) <= TOL
    for fs in pair:
        scale_big.prepare(fs)
    st, sj = ft._stepper, fj._stepper
    assert st._solver_kinds == ["multifrontal"]
    rng = np.random.default_rng(0)
    up = np.asarray(fj._carry.u_n) + 1e-2 * rng.standard_normal((2, ft.space.n_dofs))
    u_seq = 0.1 * rng.standard_normal((STEPS, 2))
    carry_t, outs_t = st.make_rollout_open_loop(True)(st.init_carry(up[0], up[1]), u_seq)
    carry_j, outs_j = sj.make_rollout_open_loop(True)(sj.init_carry(up[0], up[1]), u_seq)
    assert outs_t.y.shape == (STEPS, 3)
    for got, want in ((outs_t.y, outs_j.y), (outs_t.dE, outs_j.dE), (outs_t.x, outs_j.x)):
        assert _rel(got, want) <= TOL
    assert _rel(carry_to_numpy(carry_t)["u_n"], carry_j.u_n) <= TOL


def test_torch_scale_big_factor_entries_stream(pair, tmp_path, monkeypatch):
    """The host build into a cache directory, then the tool's set-up from
    it: the derived entry streamed (tests/test_torch_factor_cache.py holds
    a streamed layout bitwise a cold build's)."""
    ft = pair[1]
    base = tmp_path / "base"
    write_baseflow(ft, base)
    cache = tmp_path / "cache"
    report = scale_big.factor(DENSITY, cache, base_dir=base, stepper_options=MF)
    assert report.startswith(f"n_dofs {ft.space.n_dofs}:") and "factor build" in report
    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(cache))
    fs = scale_big.build(DENSITY, "dense_lu", "f32", num_steps=1, device="cpu",
                         path_out=tmp_path / "out", stepper_options=MF)
    assert scale_big.base_flow(fs, base).startswith("loaded")
    scale_big.prepare(fs)
    mf = fs._stepper._solvers[0]
    assert mf.loaded_from == "stream" and mf.dtype == torch.float32
    assert f"{len(mf.stages)} stages, {mf.factor_bytes / 1e9:.4f} GB" in report


def test_torch_scale_big_committed_baseflow_residual(big):
    big.load_steady_state(committed_baseflow(big))
    assert abs(make_baseflow.steady_residual(big) - BIG_NEWTON_RES) <= 1e-6 * BIG_NEWTON_RES
