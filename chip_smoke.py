"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``flowcontrol_tpu_torch`` (never JAX) through its main path on the
first CUDA device and fails (non-zero exit, no result line) if any phase
fails or no CUDA device is present:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions, and
   the build of kernel K1 (``csrc/nl_convection.cu``) with nvcc;
2. K1 against its plain torch version at the 56,383-dof default cylinder
   mesh, batch 1 and 4: max |kernel - plain| / max |plain| <= 1e-5 (f32 with
   a different summation order), both timed with CUDA events;
3. the main path: ``CylinderFlowSolver.make_default(Re=100)`` on ``cuda``
   (f32), Picard then Newton on the host (cd0 within 1e-6 relative of the
   JAX package's 1.1413636679 on this mesh), then 200 ``fs.step`` calls
   with u = [0.3, -0.2] for 10 steps and 0 after. All y and dE finite, and
   K1 launched steps + 1 times (the extra one is ``init_carry``);
4. accuracy: from the carry after step 10, 10 more f32 steps on the card
   against a host float64 scipy-splu loop from the same state (BDF2 with
   the AB2 nonlinear terms): relative field error <= 5e-4;
5. where the step's time goes (a measurement, no check): CUDA-event times
   of the dense LU solve, K1, the mass SpMV and the whole device step, and
   a torch.profiler trace of 10 ``fs.step`` calls giving the device's busy
   share and its top kernels.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

RE = 100
NUM_STEPS = 200
CTRL_STEPS = 10
CD0_REF = 1.1413636679  # JAX package, host f64 Picard(3)+Newton, this mesh
NDOFS_REF = 56_383
K1_TOL = 1e-5
FIELD_ERR_TOL = 5e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 50) -> float:
    """Mean device time of fn() over reps launches, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel(space, geom, dev) -> dict:
    """K1 vs its plain version on the main path's tables."""
    from flowcontrol_tpu_torch.ops.nl import (
        NLTables,
        nonlinear_convection,
        nonlinear_convection_plain,
    )

    tables = NLTables.build(geom, space, dev, torch.float32)
    rng = np.random.default_rng(0)
    res = {"max_abs_err": 0.0}
    for b in (1, 4):
        u = torch.as_tensor(
            rng.standard_normal((b, space.n_dofs)), dtype=torch.float32, device=dev
        )
        got = nonlinear_convection(tables, u)
        ref = nonlinear_convection_plain(tables, u)
        torch.cuda.synchronize()
        abs_err = float((got - ref).abs().max())
        rel = abs_err / float(ref.abs().max())
        ms = cuda_time_ms(lambda: nonlinear_convection(tables, u))
        plain_ms = cuda_time_ms(lambda: nonlinear_convection_plain(tables, u))
        log(f"phase 2: K1 B={b} n={space.n_dofs}: max|k-p|/max|p| = {rel:.3e} "
            f"(tol {K1_TOL:g}), max|k-p| = {abs_err:.3e}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
        if not rel <= K1_TOL:
            raise AssertionError(f"K1 disagrees with its plain version at B={b}: {rel:.3e}")
        res["max_abs_err"] = max(res["max_abs_err"], abs_err)
        if b == 1:  # the main path's shape
            res["ms"], res["plain_ms"] = ms, plain_ms
    return res


class HostF64Loop:
    """Host float64 reference: the BDF2 step with AB2 nonlinear terms,
    one scipy splu factor, RHS and back-substitution per step."""

    def __init__(self, fs):
        import scipy.sparse.linalg as spla

        from flowcontrol_tpu_torch.fem.assembly import to_scipy_csr

        self.fs = fs
        self.bcs = fs._bcset_perturbation()
        n = fs.space.n_dofs
        lhs = to_scipy_csr(fs.forms.transient_lhs(2, fs.fields.U0), fs.space.cell_dofs, n)
        a_bc, _ = self.bcs.eliminate_csr(lhs)
        self.mass = to_scipy_csr(fs.forms.mass_elements(), fs.space.cell_dofs, n)
        self.lu = spla.splu(a_bc.tocsc())
        self.dt = fs.params_time.dt

    def run(self, steps: int, u_n: np.ndarray, u_nn: np.ndarray) -> np.ndarray:
        from flowcontrol_tpu_torch.fem.assembly import nonlinear_convection_np

        fs, dt = self.fs, self.dt
        u_n, u_nn = u_n.astype(np.float64), u_nn.astype(np.float64)
        for _ in range(steps):
            rhs = (2.0 / dt) * (self.mass @ u_n) - (0.5 / dt) * (self.mass @ u_nn)
            rhs -= 2.0 * nonlinear_convection_np(fs.geom, fs.space, u_n)
            rhs += nonlinear_convection_np(fs.geom, fs.space, u_nn)
            rhs[self.bcs.dofs] = 0.0  # perturbation BCs at zero control
            u_nn, u_n = u_n, self.lu.solve(rhs)
        return u_n


def phase_breakdown(fs, st, dev) -> None:
    """Per-part device times of one BDF2 step at the main path's shapes."""
    from torch.profiler import ProfilerActivity, profile

    carry = fs._carry
    oi = st._order_idx[2]
    rhs = torch.ones(fs.space.n_dofs, dtype=st.dtype, device=dev)
    zero = np.zeros(st.n_act)
    t_solve = cuda_time_ms(lambda: st._solve_once(oi, rhs), reps=20)
    t_nl = cuda_time_ms(lambda: st._nl(carry.u_n))
    t_mass = cuda_time_ms(lambda: st._mass(carry.u_n))
    t_step = cuda_time_ms(lambda: st.step(carry, zero), reps=20)
    log(f"phase 5: CUDA-event ms per call: dense LU solve {t_solve:.3f}, N(u) K1 {t_nl:.4f}, "
        f"mass SpMV {t_mass:.4f}, Stepper.step span {t_step:.3f} (includes dispatch gaps)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            fs.step(zero)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side rows only (kernels, memcpys): the CPU-op rows repeat the
    # device time of the kernels they launch
    rows = [
        (e.key, getattr(e, "self_device_time_total", 0.0))
        for e in prof.key_averages()
        if str(getattr(e, "device_type", "")).endswith("CUDA")
    ]
    busy_us = sum(t for _, t in rows)
    if busy_us > 0:
        log(f"phase 5: profiler, 10 fs.step: device busy {busy_us / wall_us:.3f} of "
            f"{wall_us / 10e3:.3f} ms wall per step")
        for key, t in sorted(rows, key=lambda r: -r[1])[:6]:
            log(f"phase 5:   {t / 10e3:9.4f} ms/step  {key[:90]}")
    else:
        log("phase 5: profiler recorded no device time: busy share not measured")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs a CUDA device", file=sys.stderr)
        return 1
    from flowcontrol_tpu_torch.core.stepper import carry_from_numpy, carry_to_numpy
    from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver
    from flowcontrol_tpu_torch.ops.nl import NL_KERNEL, nonlinear_convection

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # ── phase 1: card, versions, K1 build ────────────────────────────────────
    log(card)  # as nvidia-smi gives it: name, power limit
    log(f"phase 1: nvidia-smi: {card}")
    log(f"phase 1: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {kind}, count {torch.cuda.device_count()}")
    NL_KERNEL.get()
    log(f"phase 1: K1 built from {NL_KERNEL.source.name} in {NL_KERNEL.build_seconds:.2f} s "
        f"-> {NL_KERNEL.library_path().name}")
    for line in NL_KERNEL.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"phase 1: ptxas: {line.strip()}")

    # ── phase 3 set-up (mesh) first: phase 2 runs on the same mesh ───────────
    t0 = time.perf_counter()
    fs = CylinderFlowSolver.make_default(Re=RE, num_steps=NUM_STEPS, device="cuda")
    t_mesh = time.perf_counter() - t0
    n = fs.space.n_dofs
    if n != NDOFS_REF:
        raise AssertionError(f"default mesh has {n} dofs, expected {NDOFS_REF}")

    # ── phase 2: K1 against plain ────────────────────────────────────────────
    k1 = phase_kernel(fs.space, fs.geom, dev)

    # ── phase 3: the main path ───────────────────────────────────────────────
    t0 = time.perf_counter()
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=3)
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="newton",
                            initial_guess=fs.fields.UP0, max_iter=10)
    t_base = time.perf_counter() - t0
    cd_rel = abs(fs.cd0 - CD0_REF) / CD0_REF
    log(f"phase 3: n_dofs {n}, cells {fs.mesh.num_cells}; base flow cd0 = {fs.cd0:.10f}, "
        f"cl0 = {fs.cl0:.3e} (cd0 rel diff to JAX {cd_rel:.2e}, tol 1e-6)")
    if not cd_rel <= 1e-6:
        raise AssertionError(f"cd0 {fs.cd0} differs from {CD0_REF} by {cd_rel:.2e}")

    fs.initialize_time_stepping()
    nonlinear_convection.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    st = fs.stepper  # factorization + init_carry (one K1 launch)
    torch.cuda.synchronize()
    t_factor = time.perf_counter() - t0
    ys, carry10, t_steps0 = [], None, None
    for i in range(NUM_STEPS):
        if i == CTRL_STEPS:
            torch.cuda.synchronize()
            t_steps0 = time.perf_counter()
        u = np.array([0.3, -0.2]) if i < CTRL_STEPS else np.zeros(2)
        ys.append(fs.step(u))
        if i + 1 == CTRL_STEPS:
            carry10 = carry_to_numpy(fs._carry)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t_steps0
    launches = nonlinear_convection.launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    ys = np.asarray(ys)
    de = fs.timeseries["dE"][1:]
    sps = (NUM_STEPS - CTRL_STEPS) / t_loop
    log(f"phase 3: solve kinds {st._solver_kinds}, dtype {st.dtype}, device {st.device}")
    log(f"phase 3: setup s: mesh+spaces {t_mesh:.2f}, base flow {t_base:.2f}, "
        f"factorization+init_carry {t_factor:.2f}; peak device memory {peak_gb:.2f} GB")
    log(f"phase 3: {NUM_STEPS} steps, single-stream {sps:.2f} steps/s over the last "
        f"{NUM_STEPS - CTRL_STEPS} ({card}); y[-1] = {ys[-1].tolist()}, dE[-1] = {de[-1]:.6e}")
    log(f"phase 3: K1 launches {launches} (expected {NUM_STEPS + 1})")
    if not (np.isfinite(ys).all() and np.isfinite(de).all() and len(de) == NUM_STEPS):
        raise AssertionError("non-finite y or dE on the main path")
    if launches != NUM_STEPS + 1:
        raise AssertionError(f"K1 launched {launches} times, expected {NUM_STEPS + 1}")

    # ── phase 4: accuracy against host f64 ───────────────────────────────────
    t0 = time.perf_counter()
    host = HostF64Loop(fs)
    ref = host.run(10, carry10["u_n"], carry10["u_nn"])
    carry = carry_from_numpy(carry10, dev, st.dtype)
    carry, _ = st.rollout_open_loop(carry, np.zeros((10, st.n_act)))
    got = carry.u_n.double().cpu().numpy()
    err = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    log(f"phase 4: 10-step field error f32 card vs host f64 splu = {err:.3e} "
        f"(tol {FIELD_ERR_TOL:g}; {time.perf_counter() - t0:.1f} s)")
    if not err <= FIELD_ERR_TOL:
        raise AssertionError(f"field error {err:.3e} over {FIELD_ERR_TOL:g}")

    phase_breakdown(fs, st, dev)

    print(json.dumps({"kernels": [{
        "name": "K1 nl_convection",
        "route": "cuda",
        "source": "flowcontrol_tpu_torch/csrc/nl_convection.cu",
        "replaces": "flowcontrol_tpu/ops/pallas_nl.py:136",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
