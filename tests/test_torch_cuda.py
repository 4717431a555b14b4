"""Tests of the PyTorch port that need an NVIDIA GPU (marker ``cuda``).

They skip without a CUDA device. This file imports neither JAX nor the JAX
package, so it also runs on a GPU machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

- Kernel K1 (``csrc/nl_convection.cu``) against its plain torch version
  on the coarse cylinder mesh, batch 1 and 4: relative error <= 1e-5 (f32,
  different summation order), one counted launch per call, float32 only.
- The cylinder slice on the card (f32, dense LU, K1) against the port's own
  float64 CPU run from the same base flow: y within 5e-4 relative of the
  f64 run's peak and the 10-step field within 5e-4, the f32 tolerances of
  the reference's own f32 path.
"""

import numpy as np
import pytest
import torch

from flowcontrol_tpu_torch.fem.assembly import CellGeometry
from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace
from flowcontrol_tpu_torch.mesh.generation import cylinder_mesh
from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver
from flowcontrol_tpu_torch.ops.nl import (
    NLTables,
    nonlinear_convection,
    nonlinear_convection_plain,
)

COARSE = dict(yinf=5.0, xinf=15.0, xinfa=-5.0, n1=4.0, n2=2.0, n3=0.8, segments=80)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NVIDIA GPU)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4])
def test_torch_cuda_k1_matches_plain(cuda, batch):
    space = TaylorHoodSpace.build(cylinder_mesh(**COARSE))
    tables = NLTables.build(CellGeometry(space), space, cuda, torch.float32)
    u = torch.as_tensor(
        np.random.default_rng(batch).standard_normal((batch, space.n_dofs)),
        dtype=torch.float32, device=cuda,
    )
    before = nonlinear_convection.launches
    got = nonlinear_convection(tables, u)
    ref = nonlinear_convection_plain(tables, u)
    torch.cuda.synchronize()
    assert nonlinear_convection.launches == before + 1
    assert got.shape == u.shape
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel <= 1e-5
    with pytest.raises(TypeError):
        nonlinear_convection(tables, u.double())


@pytest.mark.cuda
def test_torch_cuda_cylinder_f32_against_cpu_f64(cuda, tmp_path):
    mesh = cylinder_mesh(**COARSE)
    ref = CylinderFlowSolver.make_default(
        Re=100, mesh=mesh, path_out=tmp_path, device="cpu", precision="f64",
        solver_backend="dense_lu",
    )
    ref.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=3)
    ref.compute_steady_state(u_ctrl=[0.0, 0.0], method="newton",
                             initial_guess=ref.fields.UP0, max_iter=10)
    gpu = CylinderFlowSolver.make_default(Re=100, mesh=mesh, path_out=tmp_path, device="cuda")
    gpu._assign_steady_state(ref.fields.U0, ref.fields.P0)
    runs = []
    for fs in (ref, gpu):
        fs.initialize_time_stepping()
        runs.append(np.asarray([fs.step(np.array([0.2, -0.1])) for _ in range(10)]))
    assert gpu.stepper.dtype == torch.float32 and gpu.stepper.device.type == "cuda"
    y64, y32 = runs
    assert np.abs(y32 - y64).max() <= 5e-4 * np.abs(y64).max()
    err = np.linalg.norm(gpu.fields.up_ - ref.fields.up_) / np.linalg.norm(ref.fields.up_)
    assert err <= 5e-4
