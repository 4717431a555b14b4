"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``flowcontrol_tpu_torch`` (never JAX) through its main path on the
first CUDA device and fails (non-zero exit, no result line) if any phase
fails or no CUDA device is present:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions, and
   the builds of kernel K1 (``csrc/nl_convection.cu``) and kernels K2 and P1
   (``csrc/mf_sweep.cu``), one nvcc each, started together;
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
   share and its top kernels;
6. the multifrontal main path at the same 56,383 dofs: a second
   ``make_default(Re=100)`` on ``cuda`` with
   ``stepper_options={"force_substructure": True}`` and the first run's base
   flow; the host factorization split, stage count, factor bytes, measured
   per-solve error and solve kinds (``['borrowed', 'multifrontal']``), then
   200 ``fs.step`` calls with phase 3's controls. All y and dE finite; K1
   launched steps + 1 times, K2 and P1 exactly the launches of one solve
   (from the stage list) times the solves (1 + 20 borrowed sweeps on step
   1, then one per step, doubled by a refinement sweep when the factor asks
   for one; none in ``init_carry``);
7. K2 and P1 against their plain versions on that factor's stacks and inbox
   tables, every stage, batch 1 (the main path's) and 4: max |kernel -
   plain| / max |plain| <= 1e-5. Kernel, plain and (for K2) ``torch.bmm``
   timed over the launches of one solve: device time from torch.profiler
   (the host dispatches a small launch slower than the card runs it, so a
   CUDA-event span measures the host; it is logged too);
8. accuracy: from the multifrontal carry after step 10, 10 more f32 steps
   against the host float64 loop of phase 4: relative field error <= 5e-4;
9. where the multifrontal step's time goes: a torch.profiler trace of 10
   ``fs.step`` calls (busy share, top kernels, kernel launches per step).

The line before the last is a JSON object describing each kernel (K1, K2,
P1): its launches on its main path, its largest error against its plain
version, and the device times and least time (``bound_ms``) of the work
of one main-path call (K1) or of one solve's launches (K2, P1), from this run's
shapes: the bytes each call must move at 3.35 TB/s or its operations at the
67 TFLOP/s f32 rate, whichever is larger. The last line is
``{"ok": true, "device": {...}}``.
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
MF_TOL = 1e-5
FIELD_ERR_TOL = 5e-4
# the H100's published peaks (SXM, 700 W): memory rate and f32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def controls(i: int) -> np.ndarray:
    """The main paths' control sequence: u = [0.3, -0.2] for CTRL_STEPS steps, then 0."""
    return np.array([0.3, -0.2]) if i < CTRL_STEPS else np.zeros(2)


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


def device_ms(fns, reps: int = 20) -> float:
    """Device busy time in ms of one pass over ``fns`` (torch.profiler:
    kernels and copies only, so the host's dispatch gaps between small
    launches do not count), averaged over ``reps`` passes after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    for f in fns:
        f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for f in fns:
                f()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
             if str(getattr(e, "device_type", "")).endswith("CUDA"))
    if not us > 0:
        raise AssertionError("the profiler recorded no device time")
    return us / reps / 1e3


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time in ms for moving ``nbytes`` and doing ``flops`` f32
    operations on the card, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    abs_err = float((got - ref).abs().max())
    return abs_err / max(float(ref.abs().max()), 1e-30), abs_err


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
        span = cuda_time_ms(lambda: nonlinear_convection(tables, u))
        ms = device_ms([lambda: nonlinear_convection(tables, u)])
        plain_ms = device_ms([lambda: nonlinear_convection_plain(tables, u)])
        log(f"phase 2: K1 B={b} n={space.n_dofs}: max|k-p|/max|p| = {rel:.3e} "
            f"(tol {K1_TOL:g}), max|k-p| = {abs_err:.3e}; device time: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms; CUDA-event span of the kernel {span:.4f} ms")
        if not rel <= K1_TOL:
            raise AssertionError(f"K1 disagrees with its plain version at B={b}: {rel:.3e}")
        res["max_abs_err"] = max(res["max_abs_err"], abs_err)
        if b == 1:  # the main path's shape
            res["ms"], res["plain_ms"] = ms, plain_ms
    # one call reads u, the cell tables and the gather table once and writes
    # N(u); ~104 flops per cell and quadrature point (12 FMAs per node for
    # u_q and grad u_q, the convection, 24 for the projection)
    nc = tables.cell_vel_nodes.shape[0]
    nbytes = sum(t.nbytes for t in (tables.cell_vel_nodes, tables.dphi2, tables.wq,
                                    tables.phi2, tables.gt_vel)) + 2 * 4 * space.n_dofs
    res["bound_ms"], res["bound_by"] = bound(nbytes, nc * 7 * 104)
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


def profile_steps(fs, tag: str, steps: int = 10) -> None:
    """torch.profiler over ``steps`` fs.step calls: device busy share, top
    kernels and kernel launches per step."""
    from torch.profiler import ProfilerActivity, profile

    zero = np.zeros(2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fs.step(zero)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side rows only (kernels, memcpys): the CPU-op rows repeat the
    # device time of the kernels they launch
    rows = [
        (e.key, getattr(e, "self_device_time_total", 0.0), e.count)
        for e in prof.key_averages()
        if str(getattr(e, "device_type", "")).endswith("CUDA")
    ]
    busy_us = sum(t for _, t, _ in rows)
    if busy_us > 0:
        log(f"{tag}: profiler, {steps} fs.step: device busy {busy_us / wall_us:.3f} of "
            f"{wall_us / steps / 1e3:.3f} ms wall per step ({busy_us / steps / 1e3:.3f} ms busy); "
            f"{sum(c for _, _, c in rows) / steps:.1f} device launches per step")
        for key, t, c in sorted(rows, key=lambda r: -r[1])[:8]:
            log(f"{tag}:   {t / steps / 1e3:9.4f} ms/step  {c / steps:6.1f}/step  {key[:80]}")
    else:
        log(f"{tag}: profiler recorded no device time: busy share not measured")


def phase_breakdown(fs, st, dev) -> None:
    """Per-part device times of one BDF2 step at the main path's shapes."""
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
    profile_steps(fs, "phase 5")


def run_path(fs, counters) -> dict:
    """Factorization + init_carry, then NUM_STEPS fs.step calls with the
    phase-3 controls; every launch count set to 0 just before, read just
    after."""
    from flowcontrol_tpu_torch.core.stepper import carry_to_numpy

    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = fs.stepper  # factorization + init_carry
    torch.cuda.synchronize()
    t_factor = time.perf_counter() - t0
    ys, carry10, t_steps0 = [], None, None
    for i in range(NUM_STEPS):
        if i == CTRL_STEPS:
            torch.cuda.synchronize()
            t_steps0 = time.perf_counter()
        ys.append(fs.step(controls(i)))
        if i + 1 == CTRL_STEPS:
            carry10 = carry_to_numpy(fs._carry)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t_steps0
    launches = [c.launches for c in counters]
    ys = np.asarray(ys)
    de = fs.timeseries["dE"][1:]
    if not (np.isfinite(ys).all() and np.isfinite(de).all() and len(de) == NUM_STEPS):
        raise AssertionError("non-finite y or dE on the main path")
    return dict(st=st, t_factor=t_factor, ys=ys, de=de, carry10=carry10, launches=launches,
                sps=(NUM_STEPS - CTRL_STEPS) / t_loop,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def accuracy(host, st, carry10, tag: str) -> float:
    """10 f32 steps on the card from carry10 against the host f64 loop."""
    from flowcontrol_tpu_torch.core.stepper import carry_from_numpy

    t0 = time.perf_counter()
    ref = host.run(10, carry10["u_n"], carry10["u_nn"])
    carry = carry_from_numpy(carry10, st.device, st.dtype)
    carry, _ = st.rollout_open_loop(carry, np.zeros((10, st.n_act)))
    got = carry.u_n.double().cpu().numpy()
    err = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    log(f"{tag}: 10-step field error f32 card vs host f64 splu = {err:.3e} "
        f"(tol {FIELD_ERR_TOL:g}; {time.perf_counter() - t0:.1f} s)")
    if not err <= FIELD_ERR_TOL:
        raise AssertionError(f"field error {err:.3e} over {FIELD_ERR_TOL:g}")
    return err


def phase_mf_kernels(mf) -> dict:
    """K2 and P1 against their plain versions on every stage of ``mf``;
    device times of the launches of one solve (batch 1), each stage's
    operands in turn."""
    from flowcontrol_tpu_torch.ops.mf_matvec import (
        gather_sum_sub,
        gather_sum_sub_plain,
        stack_matvec,
        stack_matvec_plain,
    )

    dev = mf.device
    rng = np.random.default_rng(1)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    k2 = dict(max_rel=0.0, max_abs_err=0.0, bytes=0.0, flops=0.0, launches=0)
    p1 = dict(max_rel=0.0, max_abs_err=0.0, bytes=0.0, flops=0.0, launches=0)
    calls = {k: [] for k in ("k2", "k2_plain", "k2_bmm", "p1", "p1_plain")}
    buf = {b: rand(b, 1 + mf.total_contrib) for b in (1, 4)}
    for b in buf.values():
        b[:, 0] = 0.0
    last = len(mf.stages) - 1
    for si, st in enumerate(mf.stages):
        ops = [(st.inv, st.e)] + ([(st.fbi, st.e)] if si < last else []) + [(st.ginv, st.b)]
        for a, q in ops:
            m, p, _ = a.shape
            for batch in (1, 4):
                v = rand(batch, m, q)
                rel, abs_err = rel_err(stack_matvec(a, v), stack_matvec_plain(a, v))
                k2["max_rel"] = max(k2["max_rel"], rel)
                k2["max_abs_err"] = max(k2["max_abs_err"], abs_err)
            v = rand(1, m, q)
            vcol = v[0].unsqueeze(-1).contiguous()
            calls["k2"].append(lambda a=a, v=v: stack_matvec(a, v))
            calls["k2_plain"].append(lambda a=a, v=v: stack_matvec_plain(a, v))
            calls["k2_bmm"].append(lambda a=a, vcol=vcol: torch.bmm(a, vcol))
            k2["bytes"] += a.nbytes + 4 * (m * q + m * p)
            k2["flops"] += 2 * m * p * q
            k2["launches"] += 1
        for t in st.inbox:
            kmax, w = t.shape
            for batch in (1, 4):
                xe = rand(batch, w)
                rel, abs_err = rel_err(gather_sum_sub(buf[batch], t, xe),
                                       gather_sum_sub_plain(buf[batch], t, xe))
                p1["max_rel"] = max(p1["max_rel"], rel)
                p1["max_abs_err"] = max(p1["max_abs_err"], abs_err)
            xe = rand(1, w)
            calls["p1"].append(lambda t=t, xe=xe: gather_sum_sub(buf[1], t, xe))
            calls["p1_plain"].append(lambda t=t, xe=xe: gather_sum_sub_plain(buf[1], t, xe))
            # the table, xe and out once each, and every buffer entry the
            # table really references (pads read the shared zero)
            used = int(torch.unique(t[t > 0]).numel())
            p1["bytes"] += t.nbytes + 4 * (2 * w + used)
            p1["flops"] += kmax * w + w
            p1["launches"] += 1
    k2["ms"], k2["plain_ms"] = device_ms(calls["k2"]), device_ms(calls["k2_plain"])
    k2["library_ms"] = device_ms(calls["k2_bmm"])
    p1["ms"], p1["plain_ms"] = device_ms(calls["p1"]), device_ms(calls["p1_plain"])
    k2["span_ms"] = cuda_time_ms(lambda: [f() for f in calls["k2"]], reps=20)
    p1["span_ms"] = cuda_time_ms(lambda: [f() for f in calls["p1"]], reps=20)
    for name, r in (("K2", k2), ("P1", p1)):
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["flops"])
        lib = f", torch.bmm {r['library_ms']:.4f} ms" if "library_ms" in r else ""
        log(f"phase 7: {name} over {r['launches']} launches of one solve, {len(mf.stages)} stages: "
            f"max|k-p|/max|p| = {r['max_rel']:.3e} (tol {MF_TOL:g}, B=1 and 4), "
            f"max|k-p| = {r['max_abs_err']:.3e}; B=1 device time per solve: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms{lib}, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {r['bytes'] / 1e9:.4f} GB); CUDA-event span of the kernel "
            f"launches {r['span_ms']:.4f} ms (with the host's dispatch gaps)")
        if not r["max_rel"] <= MF_TOL:
            raise AssertionError(f"{name} disagrees with its plain version: {r['max_rel']:.3e}")
    return {"K2": k2, "P1": p1}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs a CUDA device", file=sys.stderr)
        return 1
    from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver
    from flowcontrol_tpu_torch.ops.cuda_build import build_all
    from flowcontrol_tpu_torch.ops.mf_matvec import MF_KERNELS, gather_sum_sub, stack_matvec
    from flowcontrol_tpu_torch.ops.nl import NL_KERNEL, nonlinear_convection

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # ── phase 1: card, versions, kernel builds ───────────────────────────────
    log(card)  # as nvidia-smi gives it: name, power limit
    log(f"phase 1: nvidia-smi: {card}")
    log(f"phase 1: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {kind}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build_all([NL_KERNEL, MF_KERNELS])
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.2f} s wall (parallel nvcc)")
    for name, lib in (("K1", NL_KERNEL), ("K2+P1", MF_KERNELS)):
        log(f"phase 1: {name} built from {lib.source.name} in {lib.build_seconds:.2f} s "
            f"-> {lib.library_path().name}")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
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

    # ── phase 3: the dense main path ─────────────────────────────────────────
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
    counters = (nonlinear_convection, stack_matvec, gather_sum_sub)
    dense = run_path(fs, counters)
    st = dense["st"]
    k1_launches = dense["launches"][0]
    log(f"phase 3: solve kinds {st._solver_kinds}, dtype {st.dtype}, device {st.device}")
    log(f"phase 3: setup s: mesh+spaces {t_mesh:.2f}, base flow {t_base:.2f}, "
        f"factorization+init_carry {dense['t_factor']:.2f}; peak device memory "
        f"{dense['peak_gb']:.2f} GB")
    log(f"phase 3: {NUM_STEPS} steps, single-stream {dense['sps']:.2f} steps/s over the last "
        f"{NUM_STEPS - CTRL_STEPS} ({card}); y[-1] = {dense['ys'][-1].tolist()}, "
        f"dE[-1] = {dense['de'][-1]:.6e}")
    log(f"phase 3: launches K1 {k1_launches} (expected {NUM_STEPS + 1}), "
        f"K2 {dense['launches'][1]}, P1 {dense['launches'][2]} (expected 0)")
    if dense["launches"] != [NUM_STEPS + 1, 0, 0]:
        raise AssertionError(f"dense path launches {dense['launches']}, "
                             f"expected {[NUM_STEPS + 1, 0, 0]}")

    # ── phase 4: accuracy against host f64 ───────────────────────────────────
    host = HostF64Loop(fs)
    accuracy(host, st, dense["carry10"], "phase 4")

    phase_breakdown(fs, st, dev)

    # ── phase 6: the multifrontal main path ──────────────────────────────────
    del st, dense["st"]
    fs._stepper = fs._carry = None  # the dense factor leaves the card
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fs2 = CylinderFlowSolver.make_default(
        Re=RE, num_steps=NUM_STEPS, device="cuda",
        stepper_options={"force_substructure": True},
    )
    fs2._assign_steady_state(fs.fields.U0, fs.fields.P0)  # the host Newton, once
    fs2.initialize_time_stepping()
    t_mesh2 = time.perf_counter() - t0
    mfp = run_path(fs2, counters)
    st2 = mfp["st"]
    oi2 = st2._order_idx[2]
    mf = st2._solvers[oi2]
    k2_per, p1_per = mf.launches_per_solve()
    solves = (1 + st2.BORROW_ITERS) + (NUM_STEPS - 1) * (1 + st2._refine.get(oi2, 0))
    expected = [NUM_STEPS + 1, solves * k2_per, solves * p1_per]
    t = mf.timings
    log(f"phase 6: solve kinds {st2._solver_kinds} (expected ['borrowed', 'multifrontal']), "
        f"dtype {st2.dtype}, refinement sweeps {st2._refine}")
    log(f"phase 6: host multifrontal s: ordering+f64 factorization "
        f"{t['ordering+factorization']:.2f}, repack {t['repack']:.2f}, error probe "
        f"{t['measure_err']:.2f}, tables {t['tables']:.2f}, upload {t['upload']:.2f}, "
        f"total {t['total']:.2f}; mesh+spaces {t_mesh2:.2f}, factorization+init_carry "
        f"{mfp['t_factor']:.2f}; peak device memory {mfp['peak_gb']:.2f} GB")
    log(f"phase 6: {len(mf.stages)} stages, factor stacks {mf.factor_bytes / 1e9:.4f} GB, "
        f"{mf.total_slots} slots, {mf.total_contrib} contributions, measured per-solve "
        f"error {mf.solve_err:.3e} (zero-sweep ceiling {mf.ZERO_SWEEP_ERR:g}); "
        f"(m, e, b) per stage {[(s.m, s.e, s.b) for s in mf.stages]}")
    log(f"phase 6: {NUM_STEPS} steps, single-stream {mfp['sps']:.2f} steps/s over the last "
        f"{NUM_STEPS - CTRL_STEPS} (dense path {dense['sps']:.2f}; {card}); "
        f"y[-1] = {mfp['ys'][-1].tolist()} (dense path {dense['ys'][-1].tolist()}), "
        f"dE[-1] = {mfp['de'][-1]:.6e}")
    log(f"phase 6: launches K1/K2/P1 {mfp['launches']} (expected {expected}: {solves} solves "
        f"x {k2_per} K2 and {p1_per} P1 per solve)")
    if st2._solver_kinds != ["borrowed", "multifrontal"]:
        raise AssertionError(f"solve kinds {st2._solver_kinds}")
    if mfp["launches"] != expected:
        raise AssertionError(f"multifrontal path launches {mfp['launches']}, expected {expected}")

    # ── phase 7: K2 and P1 against plain ─────────────────────────────────────
    mfk = phase_mf_kernels(mf)

    # ── phase 8: accuracy against host f64 ───────────────────────────────────
    accuracy(host, st2, mfp["carry10"], "phase 8")

    # ── phase 9: where the multifrontal step's time goes ─────────────────────
    oi_solve = st2._order_idx[2]
    rhs = torch.ones(n, dtype=st2.dtype, device=dev)
    log(f"phase 9: CUDA-event ms per call: multifrontal solve "
        f"{cuda_time_ms(lambda: st2._solve_once(oi_solve, rhs), reps=20):.3f}, "
        f"Stepper.step span {cuda_time_ms(lambda: st2.step(fs2._carry, np.zeros(2)), reps=20):.3f}"
        " (both include dispatch gaps)")
    profile_steps(fs2, "phase 9")

    def row(name, source, replaces, launches, r, library_ms):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": library_ms}

    src = "flowcontrol_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        row("K1 nl_convection", src + "nl_convection.cu",
            "flowcontrol_tpu/ops/pallas_nl.py:136", k1_launches, k1, None),
        row("K2 stack_matvec", src + "mf_sweep.cu",
            "flowcontrol_tpu/ops/pallas_mf_matvec.py:79", mfp["launches"][1], mfk["K2"],
            mfk["K2"]["library_ms"]),
        row("P1 gather_sum_sub", src + "mf_sweep.cu",
            "tools/pallas_gather_probe.py:50", mfp["launches"][2], mfk["P1"], None),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
