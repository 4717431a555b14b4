"""The port's eigensolvers, frequency responses, modal ROM and export helpers
against the JAX package's, on the CPU.

Small dense systems as in ``tests/test_linalg.py``, whose cases are held on
the port. Against the JAX package: the host ARPACK eigenvalues and H(jω) to
1e-10; ``eig_arnoldi_dense_device`` on ``device="cpu"`` in complex128 with
``n_krylov = n`` (where the Ritz values are exact whatever the start vector:
the JAX function draws it from ``PRNGKey(0)``, the port from a seeded
``torch.Generator``) to 1e-8 on the three leading eigenvalues, and with a
singular E and ``n_krylov`` < m its n values nearest σ against the host
ARPACK's to 1e-8, where the JAX ordering puts a spurious value first;
``get_frequency_response_device`` to 1e-10 of ``get_frequency_response_tpu``
in complex128, with dense or scipy CSR inputs, the refined answer and the
unrefined one (``stats["h_unrefined"]``); ``modal_rom``'s blocks to 1e-8; the export helpers' files
to 1e-10 of the JAX package's files.
"""

import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import torch

import flowcontrol_tpu.utils.io as io_j
import flowcontrol_tpu.utils.linalg as linalg_j
import flowcontrol_tpu_torch.utils.io as io_t
from flowcontrol_tpu.mesh.generation import cylinder_mesh as cylinder_mesh_j
from flowcontrol_tpu.models.cylinder import CylinderFlowSolver as CylJ
from flowcontrol_tpu_torch.mesh.generation import cylinder_mesh as cylinder_mesh_t
from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver as CylT
from flowcontrol_tpu_torch.utils.linalg import (
    dense_to_sparse,
    eig_arnoldi_dense_device,
    eigenproblem_slepc,
    get_field_response,
    get_frequency_response,
    get_frequency_response_device,
    get_mat_vp_shift_invert,
    modal_rom,
    sparse_to_coo_triplets,
)

torch.set_num_threads(1)

SMALL = dict(yinf=3.0, xinf=8.0, xinfa=-3.0, n1=2.0, n2=1.0, n3=0.5, segments=40)
TOL = 1e-10


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def siso_system():
    """dx = -x + u, y = 2x  →  H(jw) = 2/(jw + 1)."""
    a = sp.csr_matrix(np.array([[-1.0]]))
    q = sp.csr_matrix(np.eye(1))
    return a, np.array([[1.0]]), np.array([[2.0]]), q


def descriptor_system(n=30, seed=2):
    """A stable random A with one unstable mode and an E with a singular
    row (the pressure rows of the flow's mass)."""
    rng = np.random.default_rng(seed)
    a = -np.diag(np.linspace(0.5, 5, n)) + 0.1 * rng.standard_normal((n, n))
    a[0, 0] = 0.3
    e = np.eye(n)
    e[-1, -1] = 0.0
    return a, e, rng.standard_normal((n, 2)), rng.standard_normal((3, n))


# ── tests/test_linalg.py's cases on the port ─────────────────────────────────


def test_torch_frequency_response_siso_analytic():
    a, b, c, q = siso_system()
    ww = np.array([0.0, 0.5, 1.0, 10.0])
    h_ref = 2.0 / (1j * ww + 1.0)
    assert np.allclose(get_frequency_response(a, b, c, q, ww)[:, 0, 0], h_ref, rtol=1e-12)
    h_dev = get_frequency_response_device(a, b, c, q, ww, dtype=torch.complex128, device="cpu")
    assert np.allclose(h_dev[:, 0, 0], h_ref, rtol=1e-12)


def test_torch_frequency_response_mimo_shapes():
    n = 6
    rng = np.random.default_rng(0)
    a = sp.csr_matrix(-np.eye(n) + 0.1 * rng.standard_normal((n, n)))
    q = sp.csr_matrix(np.eye(n))
    b = rng.standard_normal((n, 2))
    c = rng.standard_normal((3, n))
    h = get_frequency_response(a, b, c, q, np.array([0.1, 1.0]))
    assert h.shape == (2, 3, 2)
    hd = c @ np.linalg.solve(1j * 0.1 * np.eye(n) - a.toarray(), b)
    assert np.allclose(h[0], hd)


def test_torch_frequency_response_device_complex64_matches_host():
    n = 8
    rng = np.random.default_rng(1)
    a_d = -2 * np.eye(n) + 0.2 * rng.standard_normal((n, n))
    b = rng.standard_normal((n, 1))
    c = rng.standard_normal((1, n))
    q = np.eye(n)
    ww = np.array([0.2, 1.0, 3.0])
    h_host = get_frequency_response(sp.csr_matrix(a_d), b, c, sp.csr_matrix(q), ww)
    stats = {}
    h_dev = get_frequency_response_device(a_d, b, c, q, ww, dtype=torch.complex64,
                                          device="cpu", stats=stats)
    for h in (h_dev, stats["h_unrefined"]):
        assert np.allclose(h, h_host, rtol=2e-4, atol=1e-6)


def test_torch_field_response():
    a, b, _, q = siso_system()
    x = get_field_response(a, b, q, [1.0])
    assert np.allclose(x[0, 0, 0], 1.0 / (1j + 1.0))


def test_torch_shift_invert_eig_generalized():
    """A x = λ E x with singular E (mimics the pressure-singular mass)."""
    n = 30
    a_d = np.diag(np.concatenate([[1.0], -np.linspace(1, 8, n - 1)]))
    rng = np.random.default_rng(0)
    a_d += 1e-3 * np.triu(rng.standard_normal((n, n)), 1)
    e_d = np.eye(n)
    e_d[-1, -1] = 0.0
    vals, vecs = get_mat_vp_shift_invert(sp.csr_matrix(a_d), sp.csr_matrix(e_d), n=3, sigma=0.5)
    assert np.allclose(np.sort(vals.real), [-1.25, -1.0, 1.0], atol=1e-3)
    for k in range(3):
        r = a_d @ vecs[:, k] - vals[k] * (e_d @ vecs[:, k])
        assert np.abs(r).max() < 1e-8
    slepc = eigenproblem_slepc(a_d, e_d, n=3, sigma=0.5, return_vectors=False)
    assert _rel(slepc, vals) <= TOL


def test_torch_arnoldi_dense_device_matches_host():
    rng = np.random.default_rng(2)
    n = 30
    a_d = -np.diag(np.linspace(0.5, 5, n)) + 0.1 * rng.standard_normal((n, n))
    a_d[0, 0] = 0.3
    e_d = np.eye(n)
    vals_host = get_mat_vp_shift_invert(sp.csr_matrix(a_d), sp.csr_matrix(e_d), n=3, sigma=0.3,
                                        return_vectors=False)
    vals_dev, vecs = eig_arnoldi_dense_device(a_d, e_d, n=3, sigma=0.3, n_krylov=25,
                                              dtype=torch.complex64, device="cpu")
    assert abs(vals_dev[0] - vals_host[0]) < 1e-2
    assert vecs.shape == (n, 3)


def test_torch_dense_to_sparse_and_triplets():
    m = dense_to_sparse(np.array([[1.0, 0.0], [0.0, 2.0]]))
    assert m.nnz == 2
    ij, v = sparse_to_coo_triplets(m)
    assert np.array_equal(ij, [[0, 0], [1, 1]]) and np.array_equal(v, [1.0, 2.0])


def test_torch_modal_rom_recovers_dominant_modes():
    """(ref: tests/test_linalg.py:140-177)"""
    a, e, b, c, expect = _rom_system()
    rom, kept = modal_rom(sp.csr_matrix(a), sp.csr_matrix(e), b, c,
                          shifts=[0 + 0.8j, 0 + 1.5j, 0 + 0.4j, 0 + 0j], k_per_shift=4)
    got = np.sort_complex(np.asarray(kept))
    assert len(got) == 4 and np.allclose(np.sort_complex(expect), got, atol=1e-7), got
    rom_eigs = np.linalg.eigvals(rom.A)
    assert rom_eigs.real.max() < 0
    for lam in kept:
        assert np.abs(rom_eigs - lam).min() < 1e-7


def _rom_system():
    rng = np.random.default_rng(3)
    blocks = [np.array([[-0.1, 0.8], [-0.8, -0.1]]),
              np.array([[-0.3, 1.5], [-1.5, -0.3]]),
              np.array([[-0.05, 0.4], [-0.4, -0.05]]),
              np.array([[-0.2]])]
    blocks += [np.array([[-5.0 - k]]) for k in range(15)]
    a0 = sla.block_diag(*blocks)
    n = a0.shape[0]
    v = rng.standard_normal((n, n)) + 3 * np.eye(n)
    m = rng.standard_normal((n, n))
    e = m @ m.T + n * np.eye(n)
    a = e @ (v @ a0 @ np.linalg.inv(v))
    expect = np.array([-0.3 + 1.5j, -0.2 + 0j, -0.1 + 0.8j, -0.05 + 0.4j])
    return a, e, rng.standard_normal((n, 2)), rng.standard_normal((2, n)), expect


# ── against the JAX package ─────────────────────────────────────────────────


def _phase_fixed(vecs):
    """Eigenvectors with their largest entry made real and positive: ARPACK
    draws a new start vector on every call, so each eigenvector comes back
    with its own phase."""
    k = np.abs(vecs).argmax(axis=0)
    ph = vecs[k, np.arange(vecs.shape[1])]
    return vecs * (np.abs(ph) / ph)[None, :]


def test_torch_host_analysis_matches_jax():
    """Host eigenvalues, eigenvectors (up to their phase) and H(jω), field
    response: the same code on the same inputs."""
    a, e, b, c = descriptor_system()
    a_s, e_s = sp.csr_matrix(a), sp.csr_matrix(e)
    vals_t, vecs_t = get_mat_vp_shift_invert(a_s, e_s, n=4, sigma=0.3 + 0.1j)
    vals_j, vecs_j = linalg_j.get_mat_vp_shift_invert(a_s, e_s, n=4, sigma=0.3 + 0.1j)
    assert _rel(vals_t, vals_j) <= TOL
    assert _rel(_phase_fixed(vecs_t), _phase_fixed(vecs_j)) <= TOL
    ww = np.array([0.1, 0.77, 2.15, 10.0])
    assert _rel(get_frequency_response(a_s, b, c, e_s, ww),
                linalg_j.get_frequency_response(a_s, b, c, e_s, ww)) <= TOL
    assert _rel(get_field_response(a_s, b, e_s, ww),
                linalg_j.get_field_response(a_s, b, e_s, ww)) <= TOL


def test_torch_arnoldi_dense_device_matches_jax():
    """n_krylov = n: the Ritz values are the eigenvalues of (A - σE)⁻¹E
    whatever the start vector, so the two packages' leading three agree."""
    n = 30
    a, e, _, _ = descriptor_system(n)
    e = np.eye(n)
    vals_t, vecs_t = eig_arnoldi_dense_device(a, sp.csr_matrix(e), n=n, sigma=0.3, n_krylov=n,
                                              dtype=torch.complex128, device="cpu")
    vals_j, _ = linalg_j.eig_arnoldi_dense_tpu(a, e, n=n, sigma=0.3, n_krylov=n,
                                               dtype=np.complex128)
    scale = np.abs(vals_j).max()
    for lam in vals_t[:3]:
        assert np.abs(vals_j - lam).min() <= 1e-8 * scale
    for lam in vals_j[:3]:
        assert np.abs(vals_t - lam).min() <= 1e-8 * scale
    for k in range(3):  # Ritz pairs of the exact space are eigenpairs
        v = vecs_t[:, k]
        assert np.abs(a @ v - vals_t[k] * (e @ v)).max() <= 1e-8 * scale * np.abs(v).max()


def test_torch_arnoldi_dense_device_keeps_nearest_sigma():
    """With a singular E and n_krylov < m the Krylov space holds the start
    vector's part in E's null space, a Ritz value θ ≈ 0 and so a spurious
    λ = σ + 1/θ. The JAX function orders every Ritz value by real part and
    puts that one first; the port keeps the n nearest σ (ARPACK's rule) and
    gives the host ARPACK eigenvalues, the JAX package's own code."""
    a, e, _, _ = descriptor_system()
    kw = dict(n=3, sigma=0.1 + 0.8j, n_krylov=20)
    host = get_mat_vp_shift_invert(sp.csr_matrix(a), sp.csr_matrix(e), n=3, sigma=kw["sigma"],
                                   return_vectors=False)
    got, _ = eig_arnoldi_dense_device(sp.csr_matrix(a), sp.csr_matrix(e), dtype=torch.complex128,
                                      device="cpu", **kw)
    assert _rel(got, host) <= 1e-8
    vals_j = np.asarray(linalg_j.eig_arnoldi_dense_tpu(a, e, dtype=np.complex128, **kw)[0])
    assert np.abs(host - vals_j[0]).min() > 1e3 * np.abs(host).max()  # the spurious λ leads
    assert _rel(vals_j[1:], host[:2]) <= 1e-8


@pytest.mark.parametrize("refined", [False, True])
@pytest.mark.parametrize("sparse_in", [False, True])
def test_torch_frequency_response_device_matches_jax(sparse_in, refined):
    a, e, b, c = descriptor_system()
    ww = np.array([0.1, 0.77, 2.15, 10.0])
    ref = linalg_j.get_frequency_response_tpu(a, b, c, e, ww, dtype=np.complex128)
    ops = (sp.csr_matrix(a), sp.csr_matrix(e)) if sparse_in else (a, e)
    stats = {}
    got = get_frequency_response_device(ops[0], b, c, ops[1], ww, dtype=torch.complex128,
                                        device="cpu", stats=stats)
    assert got.shape == (4, 3, 2) and got.dtype == np.complex128
    assert len(stats["seconds"]) == 4 and stats["h_unrefined"].shape == got.shape
    assert _rel(got if refined else stats["h_unrefined"], ref) <= TOL


def test_torch_modal_rom_matches_jax():
    """The same kept eigenvalues and A blocks. ARPACK draws a new start
    vector on every call, so each eigenvector comes back with its own phase:
    a complex pair's B_k and C_k are the same up to the rotation that phase
    fixes (the same C_k B_k, |B_k| and block response). A real mode's B_k
    and C_k take the real parts of wᴴB and Cv separately in both packages,
    so they depend on that phase (a fault of the reference's, ROADMAP,
    "Faults in the reference"); its A block is compared."""
    a, e, b, c, _ = _rom_system()
    kw = dict(shifts=[0 + 0.8j, 0 + 1.5j, 0 + 0.4j, 0 + 0j], k_per_shift=4)
    rom_t, kept_t = modal_rom(sp.csr_matrix(a), sp.csr_matrix(e), b, c, **kw)
    rom_j, kept_j = linalg_j.modal_rom(sp.csr_matrix(a), sp.csr_matrix(e), b, c, **kw)
    assert _rel(kept_t, kept_j) <= 1e-8
    assert rom_t.A.shape == rom_j.A.shape and _rel(rom_t.A, rom_j.A) <= 1e-8
    assert rom_t.B.shape == rom_j.B.shape and rom_t.C.shape == rom_j.C.shape
    assert np.array_equal(rom_t.D, rom_j.D)
    k, pairs = 0, 0
    for lam in kept_t:
        blk = slice(k, k + (1 if abs(lam.imag) <= 1e-6 else 2))
        k = blk.stop
        if blk.stop - blk.start == 1:
            continue
        pairs += 1
        bt, bj = rom_t.B[blk], rom_j.B[blk]
        ct, cj = rom_t.C[:, blk], rom_j.C[:, blk]
        assert _rel(ct @ bt, cj @ bj) <= 1e-8
        assert abs(np.linalg.norm(bt) - np.linalg.norm(bj)) <= 1e-8 * np.linalg.norm(bj)
        ak = rom_t.A[blk, blk]
        for w in (0.3, 0.8, 1.5):
            def resp(cc, bb):
                return cc @ np.linalg.solve(1j * w * np.eye(2) - ak, bb)
            assert _rel(resp(ct, bt), resp(cj, bj)) <= 1e-8
    assert pairs == 3


@pytest.fixture(scope="module")
def cylinders(tmp_path_factory):
    fj = CylJ.make_default(Re=100, num_steps=1, verbose=0, mesh=cylinder_mesh_j(**SMALL),
                           path_out=tmp_path_factory.mktemp("j"), solver_backend="host_lu",
                           precision="f64")
    ft = CylT.make_default(Re=100, num_steps=1, verbose=0, mesh=cylinder_mesh_t(**SMALL),
                           path_out=tmp_path_factory.mktemp("t"), solver_backend="host_lu",
                           precision="f64", device="cpu")
    rng = np.random.default_rng(4)
    u = rng.standard_normal((ft.space.n_vnodes, 2))
    p = rng.standard_normal(ft.space.n_pressure_dofs)
    return fj, ft, u, p


def _npz_equal(path_t, path_j):
    with np.load(path_t, allow_pickle=True) as t, np.load(path_j, allow_pickle=True) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            if j[k].dtype == object:
                assert list(t[k]) == list(j[k]), k
            else:
                assert t[k].shape == j[k].shape and _rel(t[k], j[k]) <= TOL, k


def test_torch_io_exports_match_jax(cylinders, tmp_path):
    fj, ft, u, p = cylinders
    a = sp.random(40, 40, density=0.1, random_state=5, format="csr")
    for pkg, mod, fs in (("j", io_j, fj), ("t", io_t, ft)):
        d = tmp_path / pkg
        mod.export_square_operators(d / "op", {"A": a, "M": np.arange(6.0)}, spy_png=False)
        mod.export_dof_map(d / "dofs.npz", fs.space)
        mod.export_field_vtk(d / "f.vtk", fs.space, u_nodes=u, p=p,
                             point_data={"q": p})
        mod.export_subdomains(d / "sub.npz", fs.mesh, fs.markers)
        mod.export_boundary_forces(d / "forces.npz", fs, "cylinder", u, p, 0.01)
        mod.export_stress_tensor(d / "stress.npz", fs, u, p, 0.01)
        mod.export_npz_to_mat(d / "op_A.npz", d / "op_A.mat", "A")
        mod.export_boundary_field(d / "normals.npz", fs.mesh)
    j, t = tmp_path / "j", tmp_path / "t"
    for name in ("op_M.npz", "dofs.npz", "sub.npz", "forces.npz", "stress.npz", "normals.npz"):
        _npz_equal(t / name, j / name)
    assert (t / "op_A_coo.txt").read_text() == (j / "op_A_coo.txt").read_text()
    assert (t / "f.vtk").read_text() == (j / "f.vtk").read_text()
    assert abs(sp.load_npz(t / "op_A.npz") - a).max() == 0
    import scipy.io as sio

    assert abs(sio.loadmat(t / "op_A.mat")["A"] - a).max() == 0


def test_torch_io_hw_roundtrip_and_plots(tmp_path):
    ww = np.logspace(-1, 1, 5)
    hw = (np.arange(20.0) + 1j).reshape(5, 2, 2)
    io_t.save_Hw(tmp_path / "Hw.mat", hw, ww)
    h2, w2 = io_t.load_Hw(tmp_path / "Hw.mat")
    assert np.array_equal(h2, hw) and np.array_equal(w2, ww)
    io_t.plot_Hw(tmp_path / "bode", hw, ww)
    assert sorted(f.name for f in tmp_path.glob("bode_H*.png")) == [
        "bode_H11.png", "bode_H12.png", "bode_H21.png", "bode_H22.png"]
    io_t.export_sparse_matrix(sp.eye(5, format="csr"), tmp_path / "spy.png")
    assert (tmp_path / "spy.png").stat().st_size > 0
