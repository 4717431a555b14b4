"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``flowcontrol_tpu_torch`` (never JAX) through its main path on the
first CUDA device and fails (non-zero exit, no result line) if any phase
fails or no CUDA device is present:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions, and
   the builds of kernel K1 (``csrc/nl_convection.cu``), kernels K2 and P1
   (``csrc/mf_sweep.cu``), kernel K3 (``csrc/block_trisolve.cu``), F and
   P2-P4 (``csrc/mf_fused.cu``) and S (``csrc/csr_spmm.cu``), one nvcc
   each, started together: phases 2-5g wait for K1 alone, the others
   build behind them and are waited for before phase 6 (F's library takes
   ~100 s);
2. K1 against its plain torch version at the 56,383-dof default cylinder
   mesh, batch 1, 4, 64 and 256 (the single stream's and the batched
   paths' widths): max |kernel - plain| / max |plain| <= 1e-5 (f32 with a
   different summation order), two calls bitwise equal, one counted launch
   per call; its patch count and halo share; device times (queued CUDA
   events) of both beside the bound;
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
   share and its top kernels; the device time of the pivoted factor's solve
   (the permutation and two ``solve_triangular``) for 1 and 256 right-hand
   sides (queued CUDA events), the library call K3 is held beside;
6. the multifrontal main path at the same 56,383 dofs: a second
   ``make_default(Re=100)`` on ``cuda`` with
   ``stepper_options={"force_substructure": True}`` and the first run's base
   flow; the host factorization split (a cold build, kept in the factor
   cache that phases 38, 40 and 43 stream), stage count, factor bytes, measured
   per-solve error and solve kinds (``['borrowed', 'multifrontal']``), then
   200 ``fs.step`` calls with phase 3's controls. All y and dE finite; K1
   launched steps + 1 times, and every single-stream solve one launch of
   kernel F (``csrc/mf_fused.cu``): F launched once per solve (1 + 20
   borrowed sweeps on step 1, then one per step, doubled by the refinement
   sweep every f32 factor takes; none in ``init_carry``), K2 and P1
   never;
7. K2 against its plain version on that factor's stacks, every stage,
   batch 1 and 4: max |kernel - plain| / max |plain| <= 1e-5. Kernel, plain
   and ``torch.bmm`` timed over the launches of one solve: device time from
   torch.profiler (the host dispatches a small launch slower than the card
   runs it, so a CUDA-event span measures the host; it is logged too). Then
   K2's wide instance (the tiled product) at B = 256, the cylinder's
   batched width, on every stage: against plain (<= 1e-5), two calls
   bitwise equal, one counted launch per call; kernel, plain and
   ``torch.bmm`` per solve beside the FMA bound. Then P1 at B = 256 on that
   factor's tables: each stage's inbox launch ``torch.equal`` to the earlier
   per-segment kernel and within 1e-5 of plain, the gather form (entry and
   exit permutations, every boundary) ``torch.equal`` to ``index_select``
   and to plain, one counted launch per call; one solve's worth of each
   piece of the sweep outside K2, timed by queued CUDA events, as the sweep
   makes it (P1's launches, the subtractions, the buffer's zero column) and
   as it made it before P1 took every gather (one P1 per inbox segment,
   torch's int64 index kernels, the padded entry, the zeroed buffer, the
   copy of z), ``index_select`` for the gather form, P1's plain version and
   its byte bound;
8. accuracy: from the multifrontal carry after step 10, 10 more f32 steps
   against the host float64 loop of phase 4: relative field error <= 5e-4;
9. where the multifrontal step's time goes: a torch.profiler trace of 10
   ``fs.step`` calls (busy share, top kernels, kernel launches per step);
10. the block path, single stream, at the same 56,383 dofs: a third
    ``make_default(Re=100)`` with ``stepper_options={"trisolve": "cuda"}``
    (the pivoted factor has left the card): the blocked LU factored in f64
    on the card (seconds, peak device memory), solve kinds
    ``['borrowed', 'block']``, 200 ``fs.step`` calls with phase 3's
    controls. All y and dE finite; K1 launched steps + 1 times and K3
    3 nb - 2 times per solve at one right-hand side (21 solves on the
    borrowed first step, then two per step: the solve and its refinement
    sweep; one call of the C entry point makes a solve's launches); y[-1]
    within 1e-3 of the dense path's;
11. K3 against its plain version on that factor, n = 56,383, bs = 1024,
    random right-hand sides, batch 1, 4 and 256 (every width the paths
    give it; past one right-hand side one persistent launch walks the
    panel schedule): max |kernel - plain| / max |plain| <= 1e-5 and two
    calls bitwise equal. Device time per solve (queued CUDA events) of K3
    and plain at batch 1 and 256, each beside its bound and phase 5's
    library time;
12. accuracy: from the block path's carry after step 10, 10 more f32 steps
    against the host float64 loop: relative field error <= 5e-4;
13. batched open loop on the block and the multifrontal path (the
    per-stage sweep: K2 and P1, F never; P1 once per stage with an inbox,
    once per stage for the boundary gather and once each for the entry and
    exit permutations): 256 copies
    of the state with distinct controls, 20 steps of
    ``rollout_open_loop``: aggregate steps/s over the 19 BDF2 steps, every
    member finite, exact launch counts, and y of members 0 and 255 within
    1e-4 (relative to its peak) of single-stream runs with their controls
    (the differences in dE and in the final mixed state are printed; the
    batched products sum in another order, and the state's pressure part
    moves with it from run to run);
14. batched closed loop on both paths: 256 two-state controllers through
    the port's ``Controller.discrete`` (sensor 1 fed back, the same u on
    both actuators, gains ``linspace(0.5, 1.5, 256)``), 20 steps of
    ``rollout_closed_loop``: aggregate steps/s, dE finite, u differs
    across members, and member 0 within 1e-4 of a single-stream
    ``Controller.step`` + ``fs.step`` loop with gain 0.5;
    then where one multifrontal ``Stepper.step`` at B = 256 goes
    (torch.profiler, 3 steps);
15. where the block path's step goes, single stream (10 ``fs.step`` calls)
    and at batch 256 (3 ``Stepper.step`` calls): torch.profiler busy
    share, top kernels, launches per step;
16. kernel F against its plain version (``multifrontal_solve_fused_plain``,
    the descriptor walk in torch) and against the per-stage K2/P1 sweep on
    phase 6's factor, rows 1, 4 and 8: max |F - plain| / max |plain| <= 1e-5,
    two calls bitwise equal; F's device time (CUDA events around launches
    queued behind a device sleep) and the sweep's (torch.profiler) at each
    width, with the back-to-back spans a caller sees, and at rows 1 plain's
    time beside F's bound, grid and grid syncs; one traced launch at rows 1
    and 8, its phases' device times summed by kind; P2, P3 and P4 on their own at the
    probe's shapes (v (8, 1024) and (8, 128) lanes; offsets 640 and 256),
    bitwise equal to their plain versions, timed (queued CUDA events; the
    plain versions, which read the offset on the host, by the events' span
    of back-to-back calls) beside their library calls (``torch.gather``,
    ``torch.narrow_copy``, ``Tensor.index_add_``);
17. the open cavity, single stream: ``CavityFlowSolver.make_default(Re=7500)``
    on ``cuda`` (f32) at its generated default mesh (~120k dofs, past the
    dense range, so the multifrontal solve without ``force_substructure``);
    the base flow loaded from the committed file when its mesh checksum
    matches, else Picard (10) then Newton (10) on the host, and the log
    says which; the factor streamed from the child's host build (below) and
    that build's split, stages, factor bytes, per-solve error, refinement
    sweeps; solve kinds ``['borrowed', 'multifrontal']``;
    200 ``fs.step`` calls with u = [0.5] for 10 steps and 0 after. All y and
    dE finite; K1 steps + 1 launches, F one per solve, K2 and P1 none;
18. F against plain and the sweep on the cavity factor, as in phase 16;
19. accuracy: from the cavity carry after step 10, 10 f32 steps against the
    host float64 splu loop: relative field error <= 5e-4;
20. the cavity, batched open loop: B = 64 copies of the cavity state after
    its 200 steps, controls ``linspace(0.5, 1.5, 64)``, ``init_carry`` and 20
    steps of ``rollout_open_loop`` through the per-stage sweep (K2, P1; F
    never, exact counts); aggregate steps/s over the 19 BDF2 steps; y of
    members 0 and 63 within 1e-4 of its peak against single-stream runs
    (which go through F); where one such ``Stepper.step`` goes
    (torch.profiler, 3 steps); K2's wide instance and P1 at B = 64 on the
    cavity's stages and tables, as in phase 7, and K1 at B = 64 on the
    cavity mesh;
21. where the cavity step's time goes, and the cylinder multifrontal step's
    with F and through the per-stage sweep: torch.profiler over 10 eager
    ``Stepper.step`` calls each (a CUDA graph keeps the route it was
    captured with); then phase 44 (below), the cavity's closed loop, while
    phase 17's Stepper stands;
22. the graph phases below, in sum;
23. the lid-driven cavity, single stream, on a card that holds nothing of
    the earlier phases: ``LidCavityFlowSolver.make_default(Re=8000)`` on
    ``cuda`` (f32) at ``lidcavity_mesh(64)``, 74,371 dofs (past the dense
    range: the multifrontal solve through F), its committed base flow
    where the mesh checksum matches (else the Newton continuation of
    ``models/make_baseflow.py`` on the host, and the log says which), the
    pressure pin among the BC dofs; 200 ``fs.step`` calls with the lid
    moved (u = [0.05]) for 10 steps and 0 after; y and dE finite, exact
    launches (K1 steps + 1, F one per solve, K2 and P1 none); the factor's
    stages, stack bytes, max_front, F's grid and shared memory at rows 1
    and 8;
24. F against plain and the sweep on the lid cavity's factor, as phase 16;
25. its 10-step field error against the host f64 splu loop (<= 5e-4);
    25g its graph against eager;
26. ``batch_run``'s traffic (``examples/lidcavity_workflows.py``): 8
    copies of the state plus 1e-3 x seed-0 normal noise, zero control, 50
    steps of ``rollout_open_loop`` through F at 8 rows (exact launches);
    member 0 within MEMBER_TOL of its single-stream run; K1 at B = 1 on
    the lid cavity's mesh;
27. the fluidic pinball's MIMO closed loop, single stream:
    ``PinballFlowSolver.make_default(Re=100)`` (rotation, 67,920 dofs,
    ``force_substructure``), its committed base flow (top and bottom lift
    antisymmetric within 5e-2), the example's initial condition (a bump at
    (1, 0), radius 0.6, amplitude 0.01), 200 ``fs.step`` calls, the first
    LQG_STEPS (6) with ``Controller.step`` of the committed 22-state 3 x 3
    LQG in the loop, u = +K(y), then u = 0 (the compensator was synthesized
    on the stock mesh; its own spectral radius is 4.50 a step, and on this
    mesh the loop diverges within ~20 steps: |u| and dE of the closed loop
    printed, nothing held about them); exact launches; the factor as phase
    23;
28. F against plain and the sweep on the pinball's factor;
29. its 10-step field error (<= 5e-4); 29g its graph against eager;
30. 256 copies of the state, each with the LQG at gain
    ``linspace(0.5, 1.5, 256)`` on its output (a controller search's
    traffic), LQG_STEPS steps of ``rollout_closed_loop(...,
    feedback_sign=+1)`` through K2, P1 and S (exact launches); the u of
    the members differ; member 0 within MEMBER_TOL of its single-stream
    loop; 30g the graphed closed loop against the eager one;
31. K2's wide instance and P1 at B = 256 on the pinball's stages and
    tables, as phase 7; K1 at B = 1 on its mesh;
32. the dense rule at 67,920 dofs: the pinball's default ('auto') Stepper
    after the multifrontal one left the card: what it took, the peak
    device memory of its f64 factorization, 60 steps of phase 27's loop
    and its steps/s beside the multifrontal path's; then, with that
    solver dropped and its blocks left in PyTorch's cache, the rule still
    allows 67,920 dofs (it counts the cached blocks as free), and with
    20 GB held it allows fewer (it counts what the card has free);
33. the new graph phases in sum;
34. the analysis path at the default cylinder's 56,383 dofs, on phase 3's
    host base flow and a card that holds nothing else: ``OperatorGetter``'s
    ``get_all(autodiff=False)`` on the host, then ``get_A(autodiff=True)``
    with the element Jacobians on the card in f64: max |A_ad - A_man| /
    max |A_man| <= 1e-10; nnz of A and E, ||A||_F, the shapes of B and C and
    the seconds of each call (and of a second, warm call of the element
    Jacobians alone);
35. eigenvalues: the host ``get_mat_vp_shift_invert(A, E, n=2,
    sigma=0.1+0.8j)`` (the example asks for 8; see EIG_HOST_N), its leading eigenvalue within 1e-6 of the JAX
    package's on this mesh (``EIG_REF``), then ``eig_arnoldi_dense_device``
    on the card (complex64, n_krylov = 60, A - σE formed densely from its
    triplets): its leading eigenvalue within 1e-2 of the host's; the LU's
    and the Arnoldi loop's seconds and the peak device memory;
36. the frequency response at ww = [0.77] (see FREQ_WW):
    ``get_frequency_response_device`` on the card (complex64, one
    refinement sweep with a complex128 residual) against the host
    ``get_frequency_response``: max |H_dev - H_host| / max |H_host| <= 2e-4
    (the unrefined error printed beside it); the seconds per ω on both sides
    and the peak device memory, at most two dense n x n complex64 arrays
    and ANALYSIS_SLACK;
37. controller synthesis on the host from phase 34's A, E, B, C:
    ``modal_rom(shifts=(0.1+0.8j,), k_per_shift=2)``, its leading kept
    eigenvalue within 1e-6 of ``EIG_REF``; its order, poles and H(jω) at
    phase 36's ω beside the host's H (printed, not held);
    ``lqg_regulator`` over the example's grid qx in {0.1, 1, 10} and
    ``dlqg_regulator`` at dt = 0.005, the ROM closed loop's spectral
    abscissa (the sampled loop's spectral radius) under both feedback
    signs; the sign under which every grid candidate stabilizes the ROM is
    the one phases 38-39 feed (``examples/synthesize_controller.py`` keeps
    the JAX example's -1);
38. the example at full width: a multifrontal Stepper of the cylinder
    (``force_substructure``, phase 3's base flow, the example's initial
    condition; its factor streamed from phase 6's cache entry), the three
    LQG candidates stacked and stepped as one B = 3
    ``closed_loop_fn`` rollout of 400 steps through F (exact: F launched,
    K2 and P1 not); each member's y within 5e-4 of its peak against a
    single-stream ``fs.step`` + ``Controller.step`` loop from the same
    state; terminal dE beside the open loop's;
39. the population search: ``optim_algs.minimize(None, 0, "pop", n_iter 3 (see POP_OPTIONS),
    popsize 256, sigma0 0.5, seed 0)`` over log10 (qx, ru, qw, rv), each
    generation scored by ``lqg_population_cost``: 256 compensators
    synthesized and stacked on the host, one 400-step closed-loop rollout
    of 256 cylinders through K1, K2, P1 and S. Per generation the host
    time, the device time (CUDA events around the rollout queued behind a
    device sleep), the best cost, the +inf count (at most half) and the
    launches; one graph captured for the whole search; generation 1 re-run
    bitwise; ``res.x`` as a B = 1 rollout through F within 5e-4 of its
    batched cost; the costs of theta = 0 and of the open loop.
40. checkpoints and the restart, on a card holding nothing of the earlier
    phases, in a temporary directory, with ``import h5py`` made to fail
    for the whole phase: the default cylinder's mesh written by
    ``write_xdmf_mesh`` and read back through ``make_default(meshpath=...)``
    (cells and coordinates bitwise); phase 3's base flow written to
    ``steady/`` by ``write_field_snapshot`` with its ``meta.json`` and read
    back by ``load_steady_state()`` (bitwise); a closed loop of
    RESTART_STEPS (40) ``fs.step`` calls (multifrontal: K1, F; phase 13's
    two-state controller on sensor 1, the same u on both actuators) with
    ``save_every`` RESTART_SAVE (20): the t = 0 snapshot, checkpoints at 20
    and 40, the sidecar, the CSV and the ``.xdmf`` indexes, exact
    launches; a second solver restarted at T = 20 dt from the sidecar with
    the controller's state from step 20: order 2, one system built (no
    borrowed BDF1 operator), exact launches for 20 steps (K1 one a step, F
    two: no borrowed sweep), each restarted y within RESTART_TOL (1e-5) of
    the peak |y| of the continuous run's steps 21-40; the seconds of both
    Steppers' builds (each factor streamed from phase 6's cache entry;
    phase 42 builds it cold); one checkpoint's write and read ms and its
    bytes on disk; every Binary DataItem of the U and P indexes read at its
    ``Seek`` equal to the vertex slice and the mesh;
41. the Krylov backends, with the factor cache off, on a card holding
    nothing else: ``make_default(Re=100)`` on
    ``cuda`` (an f32 step; its Krylov solve runs in f64) with
    ``solver_backend="gmres"`` and phase 3's base flow, ``krylov_rtol``
    KRYLOV_RTOL (1e-8) through ``stepper_options``; the
    SIMPLE preconditioners' host builds and the Schur inverse's bytes; 10
    (see KRYLOV_STEPS) ``fs.step`` calls with phase 3's controls, per step the cycles, Arnoldi
    steps, ``res`` (``last_solve_res``, >= 0 on every step), the step's span
    on the device timeline and the host's ms; exact launches (K1 once a step
    and in ``init_carry``; one vector's products are cuSPARSE SpMVs); a
    profile of one step; the floor (the next step's system solved for
    KRYLOV_FLOOR_CYCLES cycles by the Stepper's f64 solve and by the same
    GMRES and SIMPLE in f32, the residual after each: the f64 one reaches
    ``krylov_rtol``, the f32 one is printed, not held); phase 4's
    accuracy from the carry after step 10 (<= 5e-4); a B = 4
    ``rollout_open_loop`` of 3 steps through S (controls ``linspace(0.5,
    1.5, 4)``; exact launches: S's count follows from the cycles), member 0
    within MEMBER_TOL of its single stream (the joint inner products);
    BiCGStab for 3 steps, finite, ``res`` printed;
42. the factor cache on phase 40's restart, in a new directory removed at
    the end: the restarted Stepper built cold (``loaded_from`` 'build', then
    ``flush``), again ('stream': the derived entry read stage by stage
    through pinned staging buffers), and with the derived entry removed
    ('primary'); each one's set-up split, the entries' bytes on disk, the
    streamed load's GB/s against the same files read alone; F's solve of one
    right-hand side and ``solve_err`` bitwise equal across the three; phase
    40's 20 restarted steps rerun on the streamed factor, y bitwise equal
    (exact launches); then one factor with ``inbox='full'``,
    ``FC_MF_PACK=bucket`` and ``trim=False``: F at rows 1 and 8 and the
    per-stage sweep (K2, P1) at B = 64 against F's plain version (<= 1e-5),
    device ms per solve beside the default factor's;
43. multi-GPU through ``torch.distributed`` (``flowcontrol_tpu_torch/
    parallel``), on a card holding nothing of the earlier phases, in a
    temporary directory: the parent writes the default mesh and phase 3's
    base flow through the port's files, streams its factor from a factor
    cache of the phase's own, a copy of phase 6's entry (``force_substructure``,
    f32 with the refinement sweep; ``loaded_from`` 'stream': phase 42
    measures the cold build) and runs the single-rank references on the card;
    then a world of
    SHARD_RANKS = 4 gloo ranks, spawned and sharing this card (each rank
    builds the cylinder from those files and streams the factor): all-space
    (``shard_stepper``: 10 ``fs.step`` calls with phase 3's controls and 10
    more at zero control, field and y against the single rank's, the
    10-step field error against phase 4's host f64 loop <= 1e-4, every
    rank's state bitwise rank 0's, each rank's factor bytes at total/4 and
    its ``memory_allocated`` before and after sharding, steps/s with the
    backend and the staging, exact K1, K2 and P1 launches (K2 and P1 from
    each rank's stage slices), F never), ``DofShardedOperator`` on the mass at 56,383 dofs against the
    CSR (1e-12, f64), {batch 2, space 2} (the B = 256 open loop and the
    fused closed loop of phase 14's controllers, 10 steps each from the
    single rank's carry after its first step, against the unsharded
    rollouts, SHARD_TOL), 2 sharded GMRES steps (BDF2 from the first,
    ``gmres_iters`` 10) against the single rank's, and the sharded ω sweep
    at a reduced width (the coarse
    cylinder's 7,889 dofs: a dense complex system of the full mesh is 25.4
    GB) against the host splu (2e-4); then a world of 1 over NCCL through
    the same all-space code. A rank that fails or a world that hangs
    (collectives time out after 60 s, the world after 600 s) fails the
    phase;
44. the open cavity's closed loop (BASELINE.json config #3), run right after
    phase 21 on phase 17's solver and Stepper (no new factorization): the
    committed leading mode, ROM and discrete LQG at the generated mesh
    (``models/_controllers/cavity_*_re7500_n120068.*``, made by
    ``flowcontrol_tpu_torch/tools/cavity_feedback_synth.py``), each refused
    unless its mesh checksum is phase 17's mesh's; λ, the ROM order and the
    compensator's states logged; the example's initial condition, 1e-3 x
    Re(v) (``examples/run_cavity_feedback.start``: the Stepper kept, the
    seconds logged); CAV_FB_STEPS (4000) steps open loop
    (``make_rollout_open_loop``, u = 0) and closed loop (``closed_loop_fn(
    4000, feedback_sign=+1.0)`` with ``Controller.discrete(dt)``) under the
    graph: dE at 1000, 2000, 3000 and 4000 of each, their ratio and the
    steps/s of each; the example's eager loop (``fs.step`` + the host
    ``Controller.step``) for CAV_FB_EAGER (50) closed-loop steps, y, u and
    dE within MEMBER_TOL of the fused rollout's; exact launches on each of
    the three runs (K1 steps + 1, F one per solve, nothing else); y and dE
    finite; where the mesh has an unstable pair, closed/open energy below
    CAV_FB_RATIO (0.8) at step 4000;
45. the fluidic pinball's MIMO closed loop (BASELINE.json config #4), run
    right after phase 31 on phase 27's solver and Stepper (no new
    factorization): the committed leading mode, ROM and discrete 3 x 3 LQG
    at the generated mesh (``models/_controllers/pinball_*_re100_n67920.*``,
    made by ``flowcontrol_tpu_torch/tools/pinball_mimo_synth.py``), each
    refused unless its mesh checksum is phase 27's mesh's; λ, the ROM
    order, the compensator's states and its own spectral radius and the
    ROM's closed/open energy at the quarters of N = PIN_FB_STEPS (20,000,
    the JAX test's horizon) logged; the example's initial condition, 2e-4 x
    Re(v) (``examples/run_pinball_feedback.start``: the Stepper kept, the
    seconds logged); N steps open (u = 0) and closed (``closed_loop_fn(N,
    feedback_sign=+1.0)`` with ``Controller.discrete(dt)``) under the graph,
    as one 2-row loop through F (the open row's compensator output zeroed):
    dE at the quarters of N, their ratio, the open loop's growth and the
    steps/s; the example's eager loop for
    PIN_FB_EAGER (50) closed-loop steps, y, u and dE within MEMBER_TOL of
    the fused rollout's; exact launches on each run (K1 steps + 1, F one
    per solve, and S's batched sparse products on the 2-row loop, nothing
    else); y and dE finite; closed/open energy at step N
    logged against PIN_FB_RATIO (0.5, the JAX test's) and held below
    PIN_FB_HOLD (1: no design the search tried stays bounded below 0.5);
46. the half-million-dof cylinder (``flowcontrol_tpu_torch/tools/
    scale_big.py``, density 30: 506,553 dofs), last, on a card holding
    nothing of the earlier phases. Its BDF2 multifrontal factor is built on
    the host by ``scale_big.py``'s ``factor`` in the child process (below);
    the phase waits for it and logs its set-up split and peak host memory.
    The flow through the tool's ``build``: the
    committed base flow (``models/_baseflows/cylinder_re100_n506553.npz``),
    or a failure where its checksum does not match the mesh; the factor's
    derived entry streamed to the card ('auto' takes the multifrontal solve:
    ``loaded_from`` 'stream' and the kinds ['borrowed', 'multifrontal']
    held); stages, GB, F's grid and shared memory at 1 and 8 rows against
    the card's opt-in; BIG_STEPS (50) ``fs.step`` calls as phase 3's, exact
    K1 and F launches; the 10-step field error against an f64 reference
    whose solves are F's refined against the f64 residual to 1e-12 (below
    BIG_PIN, 1e-4); the tool's 50-step rollout at u = 0 twice (the second
    replays the graph: exact K1 and F launches, nothing else; y bitwise the
    first run's); the single stream graph against eager in turns (46g);
    F against its plain version and the per-stage sweep at this factor,
    with its bound (phase 16's routine); K1 at this mesh (phase 2's).

The BDF2 multifrontal factors of phases 17 (the open cavity), 23 (the lid
cavity), 27 (the pinball) and 46 are built on the host by one child process
(``chip_smoke.py --prebuild DIR``: the CPU, f32, BIG_CHILD_THREADS BLAS
threads, no card), started at the top of the run, into a factor cache
directory of its own, in that order, beside phases 1-16; each of those
phases waits for its factor's ``READY`` line in the child's output, logs
the child's set-up split of it and streams it to the card ('stream' held).
The cylinder's own factors are built in the main process (phase 6 cold,
phase 42 cold in a directory of its own).

Every log line starts with the seconds since the script started.

``fs.step`` runs ``Stepper.compiled_step``: from the second step of a run
a CUDA graph of the step, so phases 3, 6, 10 and 17 time and count the
graphed single stream, and the rollouts of phases 4, 8, 12, 13, 14, 19 and
20 run their steps as graphs (each graph adds the launches it captured to
the counts on every replay). The graph phases compare the two on one card:
5g (dense), 9g (multifrontal, F), 12g (block, K3) and 19g (cavity, F), the
single stream through ``fs.step`` with the eager ``Stepper.step`` put in its
place for the eager turns; 14g (the cylinder's B = 256 open and closed
loops, multifrontal through K2/P1 and block through K3) and 20g (the
cavity's B = 64 open loop) through ``make_rollout_open_loop`` and
``make_rollout_closed_loop`` against the eager loop of ``Stepper.step``.
Each: one step (a rollout) both ways, bitwise equal (the dense path may
instead be within 1e-6 relative: cuBLAS may take another algorithm under
capture); steps/s in turns (eager, graph, graph, eager); the CUDA runtime
calls that issued work from the host per step and the device's kernels and
copies per step (torch.profiler); device time per step from CUDA events
around calls queued behind a device sleep and the busy share (device /
wall); the graph memory pool's bytes. 14s and 20s: kernel S, the batched
step's sparse products summed in a fixed order, on the zero-free mass (f32)
and BDF2 refinement operator (f64) at B = 256 (cylinder) and B = 64
(cavity): the tiled kernel bitwise equal to the row-wise reference kernel
and within 1e-5 (f32) or 1e-12 (f64) of cuSPARSE's product, the fused
refinement residual bitwise equal to its composition; their times beside
the row-wise kernel, cuSPARSE's column- and row-major products, the
compositions and the bound, each matrix's stored and assembled entries
and its plan's tiles; and the launches of S (csr_matmul, csr_residual:
"S/R" in the launch lists) on the batched paths (phases 13, 14, 20),
exact. Phase 3 also holds the device mass to the assembly's nonzero
count.

The line before the last is a JSON object describing each kernel (K1 at
batch 1 (its launches: the dense path's, phase 41's, phase 43's all-space
and GMRES legs on every rank, and phase 44's), 256 (with phase 43's {batch 2, space 2}
legs) and 64, and at batch 1 on the lid cavity's and the pinball's
meshes; K2 at batch 1 (with phase 43's all-space legs), 256 (with its
{batch 2, space 2} legs) and 64, and at the pinball's 256; K3 at batch
1 and at batch 256; P1 at batch 256 (with all of phase 43's) and 64, and
at the pinball's 256; F
at the cylinder's, the cavity's, the lid cavity's and the pinball's
factor (the cylinder's launches: phase 6's and phase 42's rerun; the
cavity's: phase 17's and phase 44's) and at phase 46's 506,553-dof
factor, with K1 on that mesh; P2, P3,
P4; S's csr_matmul at batch 256 (its launches: the batched paths',
phase 41's B = 4 Krylov steps and phase 43's batch legs), f32, with its f64
and cavity numbers beside
them, and S's csr_residual at batch 256 with the cavity's beside):
its launches on its main path (K1's and K2's batched rows: their launches
on the paths of that width), its largest error
against its plain version (a K3 row's is the one measured at that row's
batch width), and the device times and least time (``bound_ms``) of the
work of one main-path call (K1, F, P2, P3, P4), of one solve's launches
(K2, P1) or of one solve (K3), from this run's shapes: the bytes each call
must move at 3.35 TB/s or its operations at the 67 TFLOP/s f32 rate,
whichever is larger. F's rows also carry ``sweep_ms``, the per-stage
sweep's device time for the same solve; P1's rows the parts and the
earlier route's times of phase 7's and 20's P1 readings (``P1_EXTRA``).
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

RE = 100
NUM_STEPS = 200
CTRL_STEPS = 10
CD0_REF = 1.1413636679  # JAX package, host f64 Picard(3)+Newton, this mesh
NDOFS_REF = 56_383
K1_TOL = 1e-5
MF_TOL = 1e-5
K3_TOL = 1e-5
F_TOL = 1e-5
CAV_RE = 7500
CAV_U = 0.5  # the cavity's control for its first CTRL_STEPS steps
CAV_BATCH = 64  # the JAX bench's cavity batch width
BATCH = 256
BATCH_STEPS = 20
#: phase 14g's block rollouts (K3, ~100 ms a B = 256 step): 9 steps, where
#: BATCH_STEPS - 1 = 19 cost ~27 s more over ten rollouts; the run's time limit
BLOCK_GRAPH_STEPS = 9
MEMBER_TOL = 1e-4  # a batch member against its single-stream run (f32, another summation order)
FIELD_ERR_TOL = 5e-4
# P1's numbers beside the kernels line's keys (phase_p1)
P1_EXTRA = ("inbox_ms", "segment_kernel_ms", "gather_ms", "torch_index_ms", "glue_ms",
            "glue_before_ms", "launches_per_solve")
# the H100's published peaks (SXM, 700 W): memory rate and f32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# f64 outside the tensor cores (NVIDIA's H100 SXM data sheet)
PEAK_F64_PER_S = 34e12


def controls(i: int, u_on=(0.3, -0.2)) -> np.ndarray:
    """The main paths' control sequence: u = u_on for CTRL_STEPS steps, then 0."""
    return np.asarray(u_on, dtype=float) * (i < CTRL_STEPS)


T_START = time.perf_counter()


def log(msg: str) -> None:
    """A log line, headed by the seconds since the script started."""
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


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
    # the profiler now and then hands back no device rows for a window of
    # tiny launches: up to three windows before giving up
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for f in fns:
                    f()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                 if str(getattr(e, "device_type", "")).endswith("CUDA"))
        if us > 0:
            return us / reps / 1e3
    raise AssertionError("the profiler recorded no device time in three windows")


def queued_ms(fn, reps: int = 20, sleep_cycles: int = 100_000_000) -> tuple[float, float]:
    """Device time per call from CUDA events around ``reps`` calls queued
    behind a device sleep (~50 ms at the H100's clock): the host enqueues
    them while the card sleeps, so no dispatch gap falls between the events.
    Returns (ms per call, host ms to enqueue all calls); the first is a
    device time only while the second stays under the sleep."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def events_ms(fn, reps: int = 20) -> float:
    """Device ms per call of ``fn`` from :func:`queued_ms`, behind a device
    sleep three times as long as the host took to enqueue the calls in a
    trial pass (at least the ~50 ms default); fails when the host still
    took longer than the card slept (the events would then time the
    host)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_trial = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_ms = max(50.0, 3.0 * host_trial)
    # torch.cuda._sleep spins the card for a number of its clock cycles:
    # ~2e6 a millisecond at the H100's clock
    ms, host_ms = queued_ms(fn, reps=reps, sleep_cycles=int(sleep_ms * 2e6))
    if not host_ms < 0.8 * sleep_ms:
        raise AssertionError(f"{reps} calls took {host_ms:.1f} ms to enqueue, past the "
                             f"{sleep_ms:.0f} ms sleep")
    return ms


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time in ms for moving ``nbytes`` and doing ``flops`` f32
    operations on the card, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    abs_err = float((got - ref).abs().max())
    return abs_err / max(float(ref.abs().max()), 1e-30), abs_err


def phase_kernel(space, geom, dev, widths=(1, 4, 64, BATCH), tag="phase 2") -> dict:
    """K1 vs its plain version on the main path's tables at each batch
    width: the single stream's 1, and the batched paths' 64 and 256; two
    calls bitwise equal, one counted launch per call."""
    from flowcontrol_tpu_torch.ops.nl import (
        NL_KERNEL,
        NLTables,
        nonlinear_convection,
        nonlinear_convection_plain,
        sample_tile,
    )

    t0 = time.perf_counter()
    tables = NLTables.build(geom, space, dev, torch.float32)
    torch.cuda.synchronize()
    pt = tables.patches
    log(f"{tag}: K1 tables built in {time.perf_counter() - t0:.3f} s: {pt.n_patches} patches of "
        f"{pt.cells} cells along a Morton curve, up to {pt.nodes.shape[1]} nodes and "
        f"{pt.slots.shape[2]} contributions a node; {len(pt.halo_node)} of the "
        f"{space.n_vnodes} velocity nodes on a patch boundary (halo share "
        f"{pt.halo_share:.4f}), {len(pt.slot_halo)} partial slots")
    rng = np.random.default_rng(0)
    res = {"max_abs_err": 0.0, "widths": {}, "n_patches": pt.n_patches,
           "halo_share": pt.halo_share}
    # one call reads u and K1's tables once and writes N(u); ~104 flops per
    # cell and quadrature point (12 FMAs per node for u_q and grad u_q, the
    # convection, 24 for the projection)
    nc = tables.cell_vel_nodes.shape[0]
    table_bytes = tables.phi2.nbytes + sum(t.nbytes for t in tables.patch_dev.values())
    for b in widths:
        u = torch.as_tensor(
            rng.standard_normal((b, space.n_dofs)), dtype=torch.float32, device=dev
        )
        before = nonlinear_convection.launches
        got = nonlinear_convection(tables, u)
        again = nonlinear_convection(tables, u)
        ref = nonlinear_convection_plain(tables, u)
        torch.cuda.synchronize()
        calls = nonlinear_convection.launches - before
        same = torch.equal(got, again)
        abs_err = float((got - ref).abs().max())
        rel = abs_err / float(ref.abs().max())
        if not (same and calls == 2):
            raise AssertionError(f"K1 at B={b}: two calls bitwise equal {same}, {calls} "
                                 f"counted launches for 2 calls")
        span = cuda_time_ms(lambda: nonlinear_convection(tables, u))
        ms = events_ms(lambda: nonlinear_convection(tables, u))
        # the plain version's einsums allocate large temporaries and can
        # stall the host on the allocator, so its device time comes from
        # the profiler (kernels and copies only)
        plain_ms = device_ms([lambda: nonlinear_convection_plain(tables, u)], reps=5)
        bnd, bnd_by = bound(table_bytes + 2 * 4 * b * space.n_dofs, b * nc * 7 * 104)
        log(f"{tag}: K1 B={b} n={space.n_dofs}: max|k-p|/max|p| = {rel:.3e} "
            f"(tol {K1_TOL:g}), max|k-p| = {abs_err:.3e}, two calls bitwise equal; "
            f"{sample_tile(b, pt.n_patches, NL_KERNEL.get().nl_samples_per_pass())} samples a "
            f"block; device time (queued "
            f"events): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd:.4f} ms "
            f"({bnd_by}, {bnd / ms:.3f} of it); CUDA-event span of the kernel {span:.4f} ms")
        if not rel <= K1_TOL:
            raise AssertionError(f"K1 disagrees with its plain version at B={b}: {rel:.3e}")
        res["max_abs_err"] = max(res["max_abs_err"], abs_err)
        res["widths"][b] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=bnd_by,
                                span_ms=span)
    if 1 in res["widths"]:  # the single stream's shape
        w1 = res["widths"][1]
        res.update(ms=w1["ms"], plain_ms=w1["plain_ms"], bound_ms=w1["bound_ms"],
                   bound_by=w1["bound_by"])
    return res


class HostF64Loop:
    """Host float64 reference: the BDF2 step with AB2 nonlinear terms,
    RHS and a float64 solve of the BDF2 system per step: one scipy splu
    factor, or ``solve`` (numpy in, numpy out) where given."""

    def __init__(self, fs, solve=None):
        import scipy.sparse.linalg as spla

        from flowcontrol_tpu_torch.fem.assembly import to_scipy_csr

        self.fs = fs
        self.bcs = fs._bcset_perturbation()
        n = fs.space.n_dofs
        self.mass = to_scipy_csr(fs.forms.mass_elements(), fs.space.cell_dofs, n)
        if solve is None:
            lhs = to_scipy_csr(fs.forms.transient_lhs(2, fs.fields.U0), fs.space.cell_dofs, n)
            a_bc, _ = self.bcs.eliminate_csr(lhs)
            solve = spla.splu(a_bc.tocsc()).solve
        self.solve = solve
        self.dt = fs.params_time.dt

    def run(self, steps: int, u_n: np.ndarray, u_nn: np.ndarray) -> np.ndarray:
        from flowcontrol_tpu_torch.fem.assembly import nonlinear_convection_np

        fs, dt = self.fs, self.dt
        u_n, u_nn = u_n.astype(np.float64), u_nn.astype(np.float64)
        n_n, n_nn = (nonlinear_convection_np(fs.geom, fs.space, u) for u in (u_n, u_nn))
        for _ in range(steps):
            rhs = (2.0 / dt) * (self.mass @ u_n) - (0.5 / dt) * (self.mass @ u_nn)
            rhs -= 2.0 * n_n
            rhs += n_nn
            rhs[self.bcs.dofs] = 0.0  # perturbation BCs at zero control
            u_nn, u_n = u_n, self.solve(rhs)
            n_nn, n_n = n_n, nonlinear_convection_np(fs.geom, fs.space, u_n)
        return u_n


def profile_steps(fs, tag: str, steps: int = 10, step=None, what: str = "fs.step") -> None:
    """torch.profiler over ``steps`` calls of ``step`` (default: fs.step
    with zero control): device busy share, top kernels and kernel launches
    per step."""
    from torch.profiler import ProfilerActivity, profile

    zero = np.zeros(fs.params_control.actuator_number)
    step = step or (lambda: fs.step(zero))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
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
        log(f"{tag}: profiler, {steps} {what}: device busy {busy_us / wall_us:.3f} of "
            f"{wall_us / steps / 1e3:.3f} ms wall per step ({busy_us / steps / 1e3:.3f} ms busy); "
            f"{sum(c for _, _, c in rows) / steps:.1f} device launches per step")
        for key, t, c in sorted(rows, key=lambda r: -r[1])[:8]:
            log(f"{tag}:   {t / steps / 1e3:9.4f} ms/step  {c / steps:6.1f}/step  {key[:80]}")
    else:
        log(f"{tag}: profiler recorded no device time: busy share not measured")


def phase_breakdown(fs, st, dev) -> dict:
    """Per-part device times of one BDF2 step at the main path's shapes.
    Returns the device time of the pivoted factor's solve for 1 and BATCH
    right-hand sides (the library call beside K3)."""
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
    lib = {}
    for b in (1, BATCH):
        panel = torch.ones((b, fs.space.n_dofs), dtype=st.dtype, device=dev)
        lib[b] = device_ms([lambda: st._solvers[oi].solve(panel)], reps=5)
    log(f"phase 5: pivoted factor's solve (permutation + two solve_triangular), device ms: "
        f"{lib[1]:.3f} at B=1, {lib[BATCH]:.3f} at B={BATCH}")
    return lib


def run_path(fs, counters, u_on=(0.3, -0.2), control=None, steps: int = NUM_STEPS) -> dict:
    """Factorization + init_carry, then ``steps`` fs.step calls with the
    controls u_on, then 0 (or, with ``control``, u = control(i, y) of step
    i and the last measurement: a closed loop); every launch count set to 0
    just before, read just after."""
    from flowcontrol_tpu_torch.core.stepper import carry_to_numpy
    from flowcontrol_tpu_torch.solvers import factor_cache

    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = fs.stepper  # factorization + init_carry
    torch.cuda.synchronize()
    t_factor = time.perf_counter() - t0
    factor_cache.flush()  # a cache entry being written, written before the timed steps
    ys, us, carry10, t_steps0 = [], [], None, None
    for i in range(steps):
        if i == CTRL_STEPS:
            torch.cuda.synchronize()
            t_steps0 = time.perf_counter()
        us.append(controls(i, u_on) if control is None else control(i, fs.y_meas))
        ys.append(fs.step(us[-1]))
        if i + 1 == CTRL_STEPS:
            carry10 = carry_to_numpy(fs._carry)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t_steps0
    launches = [c.launches for c in counters]
    ys = np.asarray(ys)
    de = fs.timeseries["dE"][1:]
    if not (np.isfinite(ys).all() and np.isfinite(de).all() and len(de) == steps):
        raise AssertionError("non-finite y or dE on the main path")
    return dict(st=st, t_factor=t_factor, ys=ys, us=np.asarray(us), de=de, carry10=carry10,
                launches=launches, sps=(steps - CTRL_STEPS) / t_loop,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def accuracy(host, st, carry10, tag: str, against: str = "host f64 splu",
             tol: float = FIELD_ERR_TOL) -> float:
    """10 f32 steps on the card from carry10 against the host f64 loop."""
    from flowcontrol_tpu_torch.core.stepper import carry_from_numpy

    t0 = time.perf_counter()
    ref = host.run(10, carry10["u_n"], carry10["u_nn"])
    carry = carry_from_numpy(carry10, st.device, st.dtype)
    carry, _ = st.rollout_open_loop(carry, np.zeros((10, st.n_act)))
    got = carry.u_n.double().cpu().numpy()
    err = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    log(f"{tag}: 10-step field error f32 card vs {against} = {err:.3e} "
        f"(tol {tol:g}; {time.perf_counter() - t0:.1f} s)")
    if not err <= tol:
        raise AssertionError(f"field error {err:.3e} over {tol:g}")
    return err


def phase_mf_kernels(mf) -> dict:
    """K2 against its plain version on every stage of ``mf``; device times
    of the launches of one solve (batch 1), each stage's operands in
    turn."""
    from flowcontrol_tpu_torch.ops.mf_matvec import stack_matvec, stack_matvec_plain

    dev = mf.device
    rng = np.random.default_rng(1)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    r = dict(max_rel=0.0, max_abs_err=0.0, bytes=0.0, flops=0.0, launches=0)
    calls = {k: [] for k in ("k2", "k2_plain", "k2_bmm")}
    last = len(mf.stages) - 1
    for si, st in enumerate(mf.stages):
        ops = [(st.inv, st.e)] + ([(st.fbi, st.e)] if si < last else []) + [(st.ginv, st.b)]
        for a, q in ops:
            m, p, _ = a.shape
            for batch in (1, 4):
                v = rand(batch, m, q)
                rel, abs_err = rel_err(stack_matvec(a, v), stack_matvec_plain(a, v))
                r["max_rel"] = max(r["max_rel"], rel)
                r["max_abs_err"] = max(r["max_abs_err"], abs_err)
            v = rand(1, m, q)
            vcol = v[0].unsqueeze(-1).contiguous()
            calls["k2"].append(lambda a=a, v=v: stack_matvec(a, v))
            calls["k2_plain"].append(lambda a=a, v=v: stack_matvec_plain(a, v))
            calls["k2_bmm"].append(lambda a=a, vcol=vcol: torch.bmm(a, vcol))
            r["bytes"] += a.nbytes + 4 * (m * q + m * p)
            r["flops"] += 2 * m * p * q
            r["launches"] += 1
    r["ms"], r["plain_ms"] = device_ms(calls["k2"]), device_ms(calls["k2_plain"])
    r["library_ms"] = device_ms(calls["k2_bmm"])
    r["span_ms"] = cuda_time_ms(lambda: [f() for f in calls["k2"]], reps=20)
    r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["flops"])
    log(f"phase 7: K2 over {r['launches']} launches of one solve, {len(mf.stages)} stages: "
        f"max|k-p|/max|p| = {r['max_rel']:.3e} (tol {MF_TOL:g}, B=1 and 4), "
        f"max|k-p| = {r['max_abs_err']:.3e}; B=1 device time per solve: kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, torch.bmm {r['library_ms']:.4f} ms, "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bytes'] / 1e9:.4f} GB); CUDA-event "
        f"span of the kernel launches {r['span_ms']:.4f} ms (with the host's dispatch gaps)")
    if not r["max_rel"] <= MF_TOL:
        raise AssertionError(f"K2 disagrees with its plain version: {r['max_rel']:.3e}")
    return r


def phase_p1(mf, batch: int, solves_per_step: int, tag: str) -> dict:
    """P1 at the batched sweep's width ``batch`` on ``mf``'s tables. Each
    stage's inbox launch torch.equal to the earlier per-segment kernel
    (``gather_sum_sub``) and within MF_TOL of the plain version; the gather
    form (entry and exit permutations, every boundary) torch.equal to
    ``torch.index_select`` on the same int32 tables and to the plain
    version; one counted launch per call. Then one solve's worth of each
    piece of the sweep outside K2, timed by queued CUDA events: P1's
    launches (inbox, boundary, entry, exit), the subtractions and the
    buffer's zero column; the same pieces as the sweep made them before P1
    took every gather (one P1 per inbox segment, torch's int64 index
    kernels, the padded entry, the zeroed buffer, the copy of z); the
    library's ``index_select`` for the gather form; P1's plain version;
    P1's bound (bytes at 3.35 TB/s: the tables, xe and out once, the src
    entries the tables really reference once)."""
    from flowcontrol_tpu_torch.ops.mf_matvec import gather_sum_sub, sweep_gather, sweep_gather_plain

    dev, n, xs, total = mf.device, mf.n, mf.work_slots, mf.total_slots
    gen = torch.Generator(device=dev).manual_seed(6)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    bb, x, z, y = rand(batch, n), rand(batch, xs), rand(batch, xs), rand(batch, xs)
    buf = rand(batch, 1 + mf.total_contrib)
    buf[:, 0] = 0.0
    stages = mf.stages
    inbox = [st for st in stages if st.p1_inbox is not None]

    def sl(st):
        return slice(st.off, st.off + st.m * st.e)

    # the inbox form: one launch a stage against the per-segment kernel and plain
    r = dict(max_abs_err=0.0, max_rel=0.0)
    got, want = x.clone(), x.clone()
    launches0 = sweep_gather.launches
    for st in inbox:
        xe = got[:, sl(st)]
        sweep_gather(st.p1_inbox, buf, xe=xe, out=xe)
        for i, (o, w, _, _) in enumerate(st.p1_inbox.segs):
            seg = want[:, st.off + o: st.off + o + w]
            gather_sum_sub(buf, st.inbox[i], seg, out=seg)
        plain = sweep_gather_plain(st.p1_inbox, buf, xe=x[:, sl(st)])
        rel, abs_err = rel_err(got[:, sl(st)], plain)
        r["max_rel"], r["max_abs_err"] = max(r["max_rel"], rel), max(r["max_abs_err"], abs_err)
    torch.cuda.synchronize()
    same_seg = torch.equal(got, want)
    counted_ok = sweep_gather.launches - launches0 == len(inbox)
    # the gather form against index_select (int32 tables) and plain
    bb_pad = torch.nn.functional.pad(bb, (0, 1))
    gathers = [(mf.p1_entry, bb, bb_pad, mf.perm32), (mf.p1_exit, x, x, mf.ipos32)] + [
        (st.p1_bd, x, x, st.bd32.reshape(-1)) for st in stages]
    same_lib = same_plain = True
    for plan, src, lib_src, idx in gathers:
        g = sweep_gather(plan, src)
        same_lib &= torch.equal(g, torch.index_select(lib_src, 1, idx))
        same_plain &= torch.equal(g, sweep_gather_plain(plan, src))
    torch.cuda.synchronize()
    log(f"{tag}: P1 B={batch}: {len(inbox)} inbox launches (of {sum(len(s.inbox) for s in stages)} "
        f"segments) torch.equal to the per-segment kernel: {same_seg}; against plain "
        f"max|k-p|/max|p| = {r['max_rel']:.3e} (tol {MF_TOL:g}), max|k-p| = {r['max_abs_err']:.3e}; "
        f"{len(gathers)} gather-form launches torch.equal to index_select: {same_lib}, to plain: "
        f"{same_plain}; one counted launch per call: {counted_ok}")
    if not (same_seg and same_lib and same_plain and counted_ok and r["max_rel"] <= MF_TOL):
        raise AssertionError(f"{tag}: P1 B={batch}: per-segment {same_seg}, index_select "
                             f"{same_lib}, plain {same_plain} ({r['max_rel']:.3e}), counts "
                             f"{counted_ok}")
    del got, want

    corr = {id(st): rand(batch, st.m * st.e) for st in stages}
    perm64 = torch.nn.functional.pad(mf.perm, (0, xs - total - 1), value=n)
    after = {
        "P1 inbox": lambda: [sweep_gather(st.p1_inbox, buf, xe=x[:, sl(st)], out=y[:, sl(st)])
                             for st in inbox],
        "P1 boundary": lambda: [sweep_gather(st.p1_bd, x) for st in stages],
        "P1 entry": lambda: sweep_gather(mf.p1_entry, bb, out=y),
        "P1 exit": lambda: sweep_gather(mf.p1_exit, x),
        "subtraction": lambda: [torch.sub(z[:, sl(st)], corr[id(st)], out=y[:, sl(st)])
                                for st in stages],
        "zero column": lambda: buf[:, :1].zero_(),
    }
    before = {
        "P1 per segment": lambda: [gather_sum_sub(buf, t, x[:, st.off + o: st.off + o + w],
                                                  out=y[:, st.off + o: st.off + o + w])
                                   for st in inbox
                                   for t, (o, w, _, _) in zip(st.inbox, st.p1_inbox.segs)],
        "boundary index": lambda: [x[:, st.bd.reshape(-1)] for st in stages],
        "entry pad + index": lambda: torch.nn.functional.pad(bb, (0, 1))[:, perm64],
        "exit index": lambda: x[:, mf.ipos],
        "copy of z": lambda: [y[:, sl(st)].copy_(corr[id(st)]) for st in stages],
        "subtraction": lambda: [y[:, sl(st)].sub_(corr[id(st)]) for st in stages],
        "zeroed buffer": lambda: torch.zeros((batch, 1 + mf.total_contrib), device=dev),
    }
    library = {
        "entry": lambda: torch.index_select(bb_pad, 1, mf.perm32),
        "boundary": lambda: [torch.index_select(x, 1, st.bd32.reshape(-1)) for st in stages],
        "exit": lambda: torch.index_select(x, 1, mf.ipos32),
    }
    # (plan, src columns) of every P1 launch of one solve
    plans = ([(st.p1_inbox, buf.shape[1]) for st in inbox] + [(mf.p1_entry, n), (mf.p1_exit, xs)]
             + [(st.p1_bd, xs) for st in stages])

    def plain_all():
        for st in inbox:
            sweep_gather_plain(st.p1_inbox, buf, xe=x[:, sl(st)], out=y[:, sl(st)])
        for plan, src in [(mf.p1_entry, bb), (mf.p1_exit, x)] + [(st.p1_bd, x) for st in stages]:
            sweep_gather_plain(plan, src)

    times = {k: {name: events_ms(fn, reps=10) for name, fn in d.items()}
             for k, d in (("after", after), ("before", before), ("library", library))}
    r["plain_ms"] = device_ms([plain_all], reps=3)
    # bytes: each table once, xe (inbox) and out once, each src entry the
    # tables reference once (the inbox's pads read position 0)
    nbytes = flops = 0.0
    for plan, cols in plans:
        refs = 0
        for i, (_, w, kmax, _) in enumerate(plan.segs):
            t = plan.table(i)
            refs += int(torch.unique(t[t < cols]).numel())
            nbytes += t.nbytes + 4.0 * batch * w * (2 if plan.sub else 1)
            flops += float(batch) * w * (kmax + 1) if plan.sub else 0.0
        nbytes += 4.0 * batch * refs
    r["bound_ms"], r["bound_by"] = bound(nbytes, flops)
    p1_names = ("P1 inbox", "P1 boundary", "P1 entry", "P1 exit")
    r["ms"] = sum(times["after"][k] for k in p1_names)
    r["inbox_ms"] = times["after"]["P1 inbox"]
    r["segment_kernel_ms"] = times["before"]["P1 per segment"]
    r["gather_ms"] = sum(times["after"][k] for k in p1_names[1:])
    r["torch_index_ms"] = sum(times["before"][k] for k in ("boundary index", "entry pad + index",
                                                           "exit index"))
    r["library_ms"] = sum(times["library"].values())
    r["glue_ms"] = sum(times["after"].values())
    r["glue_before_ms"] = sum(times["before"].values())
    r["launches_per_solve"] = mf.launches_per_solve()[1]
    r["times"] = times
    for k in ("after", "before", "library"):
        log(f"{tag}: B={batch} one solve, device ms (queued events), {k}: "
            + ", ".join(f"{name} {ms:.4f}" for name, ms in times[k].items()))
    log(f"{tag}: P1 B={batch} per solve ({r['launches_per_solve']} launches): {r['ms']:.4f} ms "
        f"(inbox {r['inbox_ms']:.4f} against the per-segment kernel's {r['segment_kernel_ms']:.4f}; "
        f"gather form {r['gather_ms']:.4f} against torch's int64 index {r['torch_index_ms']:.4f} "
        f"and index_select {r['library_ms']:.4f}), plain {r['plain_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {nbytes / 1e9:.4f} GB; {r['bound_ms'] / r['ms']:.3f} "
        f"of it); the sweep outside K2 per solve {r['glue_before_ms']:.4f} -> {r['glue_ms']:.4f} ms, "
        f"per step ({solves_per_step} solves) {solves_per_step * r['glue_before_ms']:.4f} -> "
        f"{solves_per_step * r['glue_ms']:.4f} ms")
    return r


def phase_k2_wide(mf, batch: int, tag: str) -> dict:
    """K2 at the batched path's width on every stage of ``mf``: against its
    plain version (<= MF_TOL), two calls bitwise equal, one counted launch
    per call; kernel, plain and ``torch.bmm`` (the library call, on the
    right-hand sides laid out (m, q, B)) timed over the launches of one
    solve, beside the bound and the CUDA-event span of the kernel's."""
    from flowcontrol_tpu_torch.ops.mf_matvec import stack_matvec, stack_matvec_plain

    dev = mf.device
    gen = torch.Generator(device=dev).manual_seed(5)
    r = dict(max_rel=0.0, max_abs_err=0.0, bytes=0.0, flops=0.0, launches=0)
    calls = {k: [] for k in ("k2", "plain", "bmm")}
    last = len(mf.stages) - 1
    for si, st in enumerate(mf.stages):
        ops = [(st.inv, st.e)] + ([(st.fbi, st.e)] if si < last else []) + [(st.ginv, st.b)]
        for a, q in ops:
            m, p, _ = a.shape
            v = torch.randn((batch, m, q), generator=gen, device=dev, dtype=torch.float32)
            before = stack_matvec.launches
            got, again = stack_matvec(a, v), stack_matvec(a, v)
            if stack_matvec.launches != before + 2 or not torch.equal(got, again):
                raise AssertionError(f"{tag}: K2 B={batch} stage {si}: launches "
                                     f"{stack_matvec.launches - before}, repeatable "
                                     f"{torch.equal(got, again)}")
            rel, abs_err = rel_err(got, stack_matvec_plain(a, v))
            r["max_rel"] = max(r["max_rel"], rel)
            r["max_abs_err"] = max(r["max_abs_err"], abs_err)
            del got, again
            vt = v.permute(1, 2, 0).contiguous()  # (m, q, B): bmm's layout
            calls["k2"].append(lambda a=a, v=v: stack_matvec(a, v))
            calls["plain"].append(lambda a=a, v=v: stack_matvec_plain(a, v))
            calls["bmm"].append(lambda a=a, vt=vt: torch.bmm(a, vt))
            r["bytes"] += a.nbytes + 4 * batch * (m * q + m * p)
            r["flops"] += 2 * m * p * q * batch
            r["launches"] += 1
    torch.cuda.synchronize()
    r["ms"] = device_ms(calls["k2"], reps=10)
    r["library_ms"] = device_ms(calls["bmm"], reps=10)
    r["plain_ms"] = device_ms(calls["plain"], reps=5)
    r["span_ms"] = cuda_time_ms(lambda: [f() for f in calls["k2"]], reps=10)
    r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["flops"])
    log(f"{tag}: K2 B={batch} over {r['launches']} launches of one solve, {len(mf.stages)} "
        f"stages: max|k-p|/max|p| = {r['max_rel']:.3e} (tol {MF_TOL:g}), max|k-p| = "
        f"{r['max_abs_err']:.3e}, two calls bitwise equal; device time per solve: kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, torch.bmm {r['library_ms']:.4f} ms, "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, {r['flops'] / 1e9:.2f} GFLOP, "
        f"{r['bytes'] / 1e9:.4f} GB; kernel at {r['flops'] / (r['ms'] * 1e-3) / 1e12:.2f} "
        f"TFLOP/s, {r['bound_ms'] / r['ms']:.3f} of bound); CUDA-event span of the kernel "
        f"launches {r['span_ms']:.4f} ms")
    if not r["max_rel"] <= MF_TOL:
        raise AssertionError(f"{tag}: K2 B={batch} disagrees with plain: {r['max_rel']:.3e}")
    return r


def phase_k3(blu, library_ms: dict) -> dict:
    """K3 against its plain version on the block path's factor, batch 1, 4
    and BATCH (the widths the single-stream and the batched paths give it:
    the GEMV launches at 1, the persistent panel launch past it); device
    times of K3, plain and the library call (phase 5's pivoted solve) at
    batch 1 and BATCH beside the bound, from queued CUDA events. Returns one
    result per timed batch width, each with the error measured at its own
    width."""
    from flowcontrol_tpu_torch.ops.trisolve import (
        block_lu_solve_fused,
        launches_per_solve,
        panel_ldx,
        panel_schedule,
        tiles_per_block,
    )
    from flowcontrol_tpu_torch.solvers.block_lu import block_lu_solve

    dev, n, bs = blu.lu.device, blu.n, blu.bs
    rng = np.random.default_rng(2)

    def rand(b):
        return torch.as_tensor(rng.standard_normal((b, n)), dtype=torch.float32, device=dev)

    max_abs = {}
    for b in (1, 4, BATCH):
        rhs = rand(b)
        got = block_lu_solve_fused(blu.tree(), rhs, bs=bs, n=n)
        again = block_lu_solve_fused(blu.tree(), rhs, bs=bs, n=n)
        ref = block_lu_solve(blu.tree(), rhs, bs=bs, n=n)
        torch.cuda.synchronize()
        rel, abs_err = rel_err(got, ref)
        same = torch.equal(got, again)
        log(f"phase 11: K3 B={b} n={n} n_pad={blu.n_pad} bs={bs}: max|k-p|/max|p| = {rel:.3e} "
            f"(tol {K3_TOL:g}), max|k-p| = {abs_err:.3e}, two calls bitwise equal: {same}; "
            f"{launches_per_solve(blu.nb, b)} launch(es) per solve")
        if not (rel <= K3_TOL and same and bool(torch.isfinite(got).all())):
            raise AssertionError(f"K3 at B={b}: error {rel:.3e} against plain, repeatable {same}")
        max_abs[b] = abs_err
        del got, again, ref
    tpb, ns = tiles_per_block(bs), panel_ldx(BATCH) // 64
    sched = panel_schedule(blu.nb, tpb, ns)
    split = sched[:, 3] >= 0
    log(f"phase 11: K3's panel schedule at B={BATCH}: {len(sched)} items of 64 rows over "
        f"{blu.nb} block rows ({tpb} tiles each); {int(split.sum())} of them 64-column slices "
        f"next to the critical path, so {int(split.sum()) // ns} of the "
        f"{int((~split).sum()) + int(split.sum()) // ns} tiles of lu and dinv "
        f"({int(split.sum()) // ns / (int((~split).sum()) + int(split.sum()) // ns):.3f}) are read "
        f"by {ns} blocks that run together, the others by one; one persistent launch per solve; "
        f"one right-hand side takes {launches_per_solve(blu.nb, 1)} GEMV launches")
    out = {}
    for b in (1, BATCH):
        rhs = rand(b)
        r = dict(max_abs_err=max_abs[b], library_ms=library_ms[b])
        # 3 solves: at one right-hand side 498 launches, which the launch
        # queue holds while the card sleeps
        r["ms"] = events_ms(lambda: block_lu_solve_fused(blu.tree(), rhs, bs=bs, n=n), reps=3)
        # plain's temporaries can stall the host on the allocator: profiler
        r["plain_ms"] = device_ms([lambda: block_lu_solve(blu.tree(), rhs, bs=bs, n=n)], reps=5)
        # one solve reads every block of lu but the diagonal ones, and dinv
        # in their place (n_pad^2 values in all), b once, and writes x; each
        # value read is one multiply-add per right-hand side
        nbytes = 4.0 * blu.n_pad ** 2 + 2 * 4.0 * b * n
        r["bound_ms"], r["bound_by"] = bound(nbytes, 2.0 * blu.n_pad ** 2 * b)
        log(f"phase 11: K3 B={b}: device time per solve (queued events): kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, library (pivoted factor, solve_triangular) "
            f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}, "
            f"{nbytes / 1e9:.3f} GB, {2.0 * blu.n_pad ** 2 * b:.3e} operations)")
        out[b] = r
    return out


def member_carry(carry, b: int):
    """Batch member ``b`` of a batched carry, as a single-stream carry."""
    from flowcontrol_tpu_torch.core.stepper import StepCarry

    return StepCarry(*(f[b].clone() for f in carry[:-1]), it=carry.it)


def phase_batched_open(st, up: np.ndarray, counters, tag: str, batch: int = BATCH,
                       u_dir=(0.3, -0.2)) -> dict:
    """``batch`` copies of the state ``up`` with distinct controls
    (``linspace(0.5, 1.5, batch)`` times ``u_dir``) through ``init_carry`` +
    ``rollout_open_loop``; members 0 and batch-1 against single-stream runs
    with their controls."""
    amps = np.linspace(0.5, 1.5, batch)
    u_seq = np.tile(amps[:, None] * np.asarray(u_dir), (BATCH_STEPS, 1, 1))
    up_b = torch.as_tensor(up, dtype=st.dtype, device=st.device).expand(batch, -1).contiguous()
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    carry = st.init_carry(up_b)
    carry, first = st.rollout_open_loop(carry, u_seq[:1])  # the borrowed BDF1 step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, rest = st.rollout_open_loop(carry, u_seq[1:])
    torch.cuda.synchronize()
    sps = (BATCH_STEPS - 1) * batch / (time.perf_counter() - t0)
    launches = [c.launches for c in counters]
    y, de = torch.cat([first.y, rest.y]), torch.cat([first.dE, rest.dE])
    finite = bool(torch.isfinite(y).all() and torch.isfinite(de).all()
                  and torch.isfinite(carry.u_n).all())
    if not finite or bool(rest.diverged.any()) or y.shape != (BATCH_STEPS, batch, st.ns):
        raise AssertionError(f"{tag}: a batch member is not finite")
    spread = float((y[-1, 0] - y[-1, -1]).abs().max())
    y_errs, de_errs, x_errs = [], [], []
    for b in (0, batch - 1):
        c1, o1 = st.rollout_open_loop(st.init_carry(up), u_seq[:, b])
        y_errs.append(rel_err(y[:, b], o1.y)[0])
        de_errs.append(rel_err(de[:, b], o1.dE)[0])
        x_errs.append(float((carry.u_n[b] - c1.u_n).norm() / c1.u_n.norm()))
    log(f"{tag}: B={batch}, {BATCH_STEPS} steps: {sps:.1f} aggregate steps/s over the "
        f"{BATCH_STEPS - 1} BDF2 steps; all members finite; y[-1] of members 0 and "
        f"{batch - 1} differ by {spread:.3e}; members 0 and {batch - 1} against single-stream "
        f"runs: y max|b-s|/max|s| {y_errs[0]:.3e}, {y_errs[1]:.3e} (tol {MEMBER_TOL:g}); "
        f"measured, not held: dE {de_errs[0]:.3e}, {de_errs[1]:.3e}, final mixed state "
        f"(relative L2) {x_errs[0]:.3e}, {x_errs[1]:.3e}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not (max(y_errs) <= MEMBER_TOL and spread > 0):
        raise AssertionError(f"{tag}: batch members against single-stream runs: {y_errs}")
    return dict(sps=sps, launches=launches, carry=carry, y_last=y[-1])


def controller_population(st, dt: float):
    """BATCH two-state controllers: sensor 1 fed back, the same u on both
    actuators, gains linspace(0.5, 1.5). Returns (A, B, C, D of the
    unit-gain controller with the sensor selection and the actuator
    duplication folded in, gains, stacked k_mats)."""
    from flowcontrol_tpu_torch.core.controller import Controller

    sel = np.zeros((1, st.ns))
    sel[0, 0] = 1.0
    dup = np.ones((st.n_act, 1))
    a, b = np.array([[-2.0, 1.0], [0.0, -3.0]]), np.array([[0.5], [1.0]])
    c, d = np.array([[0.2, 0.1]]), np.zeros((1, 1))
    ad, bd, cd, dd = Controller.from_matrices(A=a, B=b, C=c, D=d).discrete(dt, dtype=np.float32)
    gains = np.linspace(0.5, 1.5, BATCH, dtype=np.float32)
    k_mats = (
        np.tile(ad, (BATCH, 1, 1)),
        np.tile((bd @ sel).astype(np.float32), (BATCH, 1, 1)),
        gains[:, None, None] * (dup @ cd).astype(np.float32),
        gains[:, None, None] * (dup @ dd @ sel).astype(np.float32),
    )
    return (a, b, dup @ c, dup @ d), gains, k_mats


def phase_batched_closed(fs, st, carry, y0, counters, tag: str) -> dict:
    """BATCH controllers on the batched carry through ``rollout_closed_loop``
    (every step BDF2: the carry continues the open-loop rollout); member 0
    against a single-stream ``Controller.step`` + ``fs.step`` loop."""
    from flowcontrol_tpu_torch.core.controller import Controller

    dt = fs.params_time.dt
    (a, b, c, d), gains, k_mats = controller_population(st, dt)
    for cnt in counters:
        cnt.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, (ys, des, us, divs) = st.rollout_closed_loop(carry, k_mats, y0, BATCH_STEPS)
    torch.cuda.synchronize()
    sps = BATCH_STEPS * BATCH / (time.perf_counter() - t0)
    launches = [cnt.launches for cnt in counters]
    spread = float((us[:, 0] - us[:, -1]).abs().max())
    if not (bool(torch.isfinite(des).all() and torch.isfinite(ys).all()) and spread > 0
            and not bool(divs.any()) and us.shape == (BATCH_STEPS, BATCH, st.n_act)):
        raise AssertionError(f"{tag}: closed-loop rollout not finite, or u equal across members")
    # member 0 through the normal entry points, gain 0.5
    k0 = Controller.from_matrices(A=a, B=b, C=float(gains[0]) * c, D=float(gains[0]) * d)
    fs._carry = member_carry(carry, 0)
    y, ys1, us1 = y0[0].double().cpu().numpy(), [], []
    for _ in range(BATCH_STEPS):
        u = k0.step(-y[:1], dt)
        y = fs.step(u_ctrl=u)
        ys1.append(y)
        us1.append(u)
    err_y = rel_err(ys[:, 0].double().cpu(), torch.as_tensor(np.asarray(ys1)))[0]
    err_u = rel_err(us[:, 0].double().cpu(), torch.as_tensor(np.asarray(us1)))[0]
    log(f"{tag}: B={BATCH} controllers, {BATCH_STEPS} steps: {sps:.1f} aggregate steps/s; dE "
        f"finite; max|u| {float(us.abs().max()):.3e}, u of members 0 and {BATCH - 1} differ by "
        f"{spread:.3e}; member 0 against the single-stream Controller.step + fs.step loop "
        f"(gain {float(gains[0]):g}), relative: y {err_y:.3e}, u {err_u:.3e} (tol {MEMBER_TOL:g})")
    if not max(err_y, err_u) <= MEMBER_TOL:
        raise AssertionError(f"{tag}: member 0 against its single-stream loop: {err_y}, {err_u}")
    return dict(sps=sps, launches=launches)


def phase_fused(mf, tag: str) -> dict:
    """Kernel F against its plain version and the per-stage K2/P1 sweep on
    ``mf``, rows 1, 4 and 8 (random right-hand sides): relative error, two
    calls bitwise equal; F's and the sweep's times per solve at each width,
    and at 1 (the main path's) the plain version's and the bound."""
    from flowcontrol_tpu_torch.ops.mf_fused import (
        F_BLOCK_THREADS,
        fused_grid,
        fused_phase_times,
        grid_syncs,
        multifrontal_solve_fused,
        multifrontal_solve_fused_plain,
    )
    from flowcontrol_tpu_torch.solvers.multifrontal import multifrontal_solve

    dev = mf.device
    rng = np.random.default_rng(4)
    res = {"max_abs_err": 0.0}
    for rows in (1, 4, 8):
        b = torch.as_tensor(rng.standard_normal((rows, mf.n)), dtype=torch.float32, device=dev)
        got = multifrontal_solve_fused(mf, b)
        again = multifrontal_solve_fused(mf, b)
        plain = multifrontal_solve_fused_plain(mf, b)
        sweep = multifrontal_solve(mf, b)
        torch.cuda.synchronize()
        rel, abs_err = rel_err(got, plain)
        rel_sweep = rel_err(got, sweep)[0]
        same = torch.equal(got, again)
        log(f"{tag}: F rows={rows} n={mf.n}: max|F-plain|/max|plain| = {rel:.3e} (tol {F_TOL:g}), "
            f"max|F-plain| = {abs_err:.3e}; against the per-stage K2/P1 sweep {rel_sweep:.3e} "
            f"(bitwise equal: {torch.equal(got, sweep)}); two calls bitwise equal: {same}")
        if not (rel <= F_TOL and rel_sweep <= F_TOL and same and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{tag}: F at rows={rows}: {rel:.3e} against plain, "
                                 f"{rel_sweep:.3e} against the sweep, repeatable {same}")
        res["max_abs_err"] = max(res["max_abs_err"], abs_err)
    # device time of F: CUDA events around launches queued behind a device
    # sleep (torch.profiler's per-kernel time under-reads back-to-back
    # cooperative launches: 0.31-0.40 ms at the cylinder against 0.62 from
    # these events and 0.64-0.66 inside a profiled step; after the graph
    # phases a window of F launches alone came back with no device record
    # at all three times running, so F is not timed by it); the sweep's from
    # the profiler (its host enqueue outlasts any sleep). Both also as
    # CUDA-event spans of back-to-back calls, dispatch gaps included: the
    # time per solve a caller sees. Widths 1 (the main path's), 4 and 8.
    widths = {}
    for rows in (1, 4, 8):
        b = torch.as_tensor(rng.standard_normal((rows, mf.n)), dtype=torch.float32, device=dev)
        f_ms, f_host = queued_ms(lambda: multifrontal_solve_fused(mf, b))
        if not f_host < 40.0:
            raise AssertionError(f"{tag}: F's calls took {f_host:.1f} ms to enqueue, past the sleep")
        w = dict(ms=f_ms, sweep_ms=device_ms([lambda: multifrontal_solve(mf, b)]),
                 span=cuda_time_ms(lambda: multifrontal_solve_fused(mf, b), reps=20),
                 sweep_span=cuda_time_ms(lambda: multifrontal_solve(mf, b), reps=20))
        if rows == 1:
            w["plain_ms"] = device_ms([lambda: multifrontal_solve_fused_plain(mf, b)], reps=5)
        widths[rows] = w
        log(f"{tag}: rows={rows} per solve: F device {w['ms']:.4f} ms (queued events), per-stage "
            f"sweep device {w['sweep_ms']:.4f} ms (profiler); back-to-back spans with dispatch: "
            f"F {w['span']:.4f} ms, sweep {w['sweep_span']:.4f} ms")
    res.update(ms=widths[1]["ms"], plain_ms=widths[1]["plain_ms"],
               sweep_ms=widths[1]["sweep_ms"], widths=widths)
    # one solve reads every factor stack, the index tables and the
    # permutations once, b once, and writes x; each stack value is one
    # multiply-add per right-hand side, each inbox entry one add
    tables = mf.flat_bd.nbytes + mf.flat_inbox.nbytes + mf.perm.nbytes + mf.ipos.nbytes
    nbytes = mf.factor_bytes + tables + mf.desc.nbytes + 2 * 4 * mf.n
    flops = 2.0 * mf.factor_bytes / 4 + mf.flat_inbox.numel()
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops)
    g = fused_grid(1, mf.max_front, len(mf.stages))
    g8 = fused_grid(8, mf.max_front, len(mf.stages))
    log(f"{tag}: F rows=1 device time per solve {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, per-stage sweep "
        f"{res['sweep_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}, "
        f"{nbytes / 1e9:.4f} GB, {nbytes / (res['ms'] * 1e-3) / 1e12:.2f} TB/s achieved, "
        f"{res['bound_ms'] / res['ms']:.3f} of bound); rows 8 at {widths[8]['ms'] / res['ms']:.2f}x "
        f"rows 1; grid {g['blocks']} blocks of {F_BLOCK_THREADS} threads ({g['per_sm']} per SM x "
        f"{g['sms']} "
        f"SMs; rows 8: {g8['per_sm']} per SM) with node vectors of {mf.max_front} floats, "
        f"{grid_syncs(mf)} grid syncs per solve, {len(mf.stages)} stages")
    res["grid_syncs"] = grid_syncs(mf)
    # where F's time goes: one traced launch per width, phase by phase (the
    # card's global timer after every grid sync), summed by kind of phase
    for rows in (1, 8):
        b = torch.as_tensor(rng.standard_normal((rows, mf.n)), dtype=torch.float32, device=dev)
        fused_phase_times(mf, b)  # warm
        phases = fused_phase_times(mf, b)
        kinds = {}
        for ph in phases:
            key = f"{ph['phase']} ({'leaf stages' if len(ph['stages']) > 1 else 'per stage'})"
            us, nb, k = kinds.get(key, (0.0, 0, 0))
            kinds[key] = (us + ph["us"], nb + ph["bytes"], k + 1)
        total = sum(ph["us"] for ph in phases)
        log(f"{tag}: F rows={rows} traced: {total:.1f} us over {len(phases)} phases; "
            + "; ".join(f"{key} x{k}: {us:.1f} us, {nb / 1e6:.1f} MB"
                        for key, (us, nb, k) in kinds.items()))
    return res


def phase_probes(dev) -> dict:
    """P2, P3 and P4 on their own at the probe's shapes against their plain
    versions, bitwise; device times beside the bound."""
    from flowcontrol_tpu_torch.ops.mf_fused import (
        dynamic_offset_accum_store,
        dynamic_offset_accum_store_plain,
        dynamic_slice,
        dynamic_slice_plain,
        take_along_axis_lanes,
        take_along_axis_lanes_plain,
    )

    rng = np.random.default_rng(0)  # the probe's own inputs

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev)

    n, w = 1024, 128
    v1 = f32(rng.standard_normal(n))
    rng.integers(0, n, (8, w))  # the probe's 2-D table (P1's shape), drawn in its order
    v2 = f32(rng.standard_normal((8, n)))
    lanes = i32(rng.integers(0, n, (8, w)))
    s_ds, s_acc = i32([640]), i32([256])
    lanes64 = lanes.long()
    rows_acc = torch.arange(256, 256 + w, device=dev)  # P4's offset, as index_add_ takes it
    out = {}
    cases = {
        "P2": (lambda: take_along_axis_lanes(v2, lanes),
               lambda: take_along_axis_lanes_plain(v2, lanes),
               lambda: torch.gather(v2, 1, lanes64),
               # idx and out once, and the v values the lanes really read
               4.0 * (2 * 8 * w + int(torch.unique(lanes64 + n * torch.arange(8, device=dev)[:, None]).numel())),
               0.0),
        "P3": (lambda: dynamic_slice(v1, s_ds, w),
               lambda: dynamic_slice_plain(v1, s_ds, w),
               lambda: torch.narrow_copy(v1, 0, 640, w), 4.0 * (2 * w + 1), 0.0),
        "P4": (lambda: dynamic_offset_accum_store(v1.clone(), s_acc, v1[:w]),
               lambda: dynamic_offset_accum_store_plain(v1.clone(), s_acc, v1[:w]),
               lambda: v1.clone().index_add_(0, rows_acc, v1[:w]),
               4.0 * (3 * w + 1), float(w)),
    }
    for name, (kern, plain, lib, nbytes, flops) in cases.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        r = {"max_abs_err": float((got - ref).abs().max())}
        # queued CUDA events: after the graph phases the profiler dropped
        # whole windows of these microsecond launches. The plain versions of
        # P3 and P4 read the offset on the host (a sync a call), so they
        # cannot queue behind a sleep: theirs is the events' span of
        # back-to-back calls
        r["ms"], r["plain_ms"] = events_ms(kern, reps=50), cuda_time_ms(plain, reps=50)
        r["library_ms"] = events_ms(lib, reps=50) if lib is not None else None
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops)
        lib_name = {"P2": "torch.gather", "P3": "torch.narrow_copy", "P4": "index_add_"}[name]
        lib_s = f", {lib_name} {r['library_ms']:.4f} ms" if lib is not None else ""
        log(f"phase 16: {name} at the probe's shapes: bitwise equal to plain: {same}; device "
            f"time kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms{lib_s}, bound "
            f"{r['bound_ms']:.3e} ms ({r['bound_by']})")
        if not same:
            raise AssertionError(f"{name} differs from its plain version by {r['max_abs_err']}")
        out[name] = r
    return out


# ── The compiled entry points: CUDA graphs against the eager step ──────────

CARRY_FIELDS = ("u_n", "u_nn", "mu_n", "mu_nn", "n_prev", "u_ctrl_prev")
# the CUDA runtime calls that issue work from the host (kernel and
# cooperative launches, graph launches, copies, sets)
HOST_CALLS = ("LaunchKernel", "LaunchCooperativeKernel", "GraphLaunch", "Memcpy", "Memset")


def launch_counts(run, steps: int) -> dict:
    """torch.profiler over one ``run()`` of ``steps`` steps (after one
    unprofiled run): device kernels and copies per step, and the CUDA
    runtime calls per step that issued work from the host, by name."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device, host = 0, {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            device += e.count
        elif e.key.startswith("cu") and any(h in e.key for h in HOST_CALLS):
            host[e.key] = host.get(e.key, 0) + e.count
    return dict(device=device / steps, host=sum(host.values()) / steps,
                calls={k: round(v / steps, 2) for k, v in sorted(host.items())})


def in_turns(runs: dict, work: float) -> dict:
    """Rates of the runs ``runs`` ({"eager": run, "graph": run}, each a
    synchronised loop doing ``work`` steps) in turns on one card: eager,
    graph, graph, eager. Returns {name: [rate, rate]}."""
    rates = {"eager": [], "graph": []}
    for name in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize()
        rates[name].append(work / (time.perf_counter() - t0))
    return rates


def same_bits(pairs, path: str) -> str:
    """'bitwise' when every (got, want) pair is equal bit for bit; on the
    dense path the largest relative difference otherwise (cuBLAS may take
    another algorithm under capture); fails on any other path."""
    worst = 0.0
    for got, want in pairs:
        if not torch.equal(got, want):
            g, w = got.double(), want.double()
            worst = max(worst, float((g - w).abs().max() / w.abs().max()))
    if worst == 0.0:
        return "bitwise"
    if path != "dense" or not worst <= 1e-6:
        raise AssertionError(f"graph replay differs from the eager step on the {path} path: "
                             f"{worst:.3e}")
    return f"within {worst:.2e} relative"


def graph_report(tag: str, what: str, rates: dict, counts: dict, dev_ms: dict, check: str,
                 pool: int, batch: int) -> dict:
    """Logs and returns one graph-against-eager comparison: rates (steps/s,
    aggregate past one stream), wall and device ms per step, busy share
    (device / wall), host launch calls per step, the replay's check and the
    graph pool's bytes."""
    wall = {k: batch * 1e3 / (sum(v) / len(v)) for k, v in rates.items()}  # ms per step
    busy = {k: dev_ms[k] / wall[k] for k in wall}
    unit = "steps/s" if batch == 1 else "aggregate steps/s"
    log(f"{tag}: {what}, graph against eager, in turns (eager, graph, graph, eager): eager "
        f"{rates['eager'][0]:.1f}, {rates['eager'][1]:.1f} {unit}, graph {rates['graph'][0]:.1f}, "
        f"{rates['graph'][1]:.1f} {unit}; wall per step eager {wall['eager']:.4f} ms, graph "
        f"{wall['graph']:.4f} ms; device per step (queued CUDA events) eager "
        f"{dev_ms['eager']:.4f} ms, graph {dev_ms['graph']:.4f} ms; busy share eager "
        f"{busy['eager']:.3f}, graph {busy['graph']:.3f}; host launch calls per step eager "
        f"{counts['eager']['host']:.1f} {counts['eager']['calls']}, graph "
        f"{counts['graph']['host']:.1f} {counts['graph']['calls']}; device kernels and copies per "
        f"step eager {counts['eager']['device']:.1f}, graph {counts['graph']['device']:.1f}; "
        f"replay against the eager step: {check}; graph pool {pool / 1e6:.1f} MB")
    return dict(rates=rates, wall_ms=wall, dev_ms=dev_ms, busy=busy,
                host=(counts["eager"]["host"], counts["graph"]["host"]), check=check, pool=pool)


def phase_graph_single(fs, st, path: str, tag: str, reps: int = 100) -> dict:
    """The single stream through ``fs.step``: Stepper.compiled_step (the
    graph) against Stepper.step (eager). One step from the current carry
    both ways, held bit for bit (the dense path: or within 1e-6); steps/s
    in turns; host launch calls and device kernels per step
    (torch.profiler); device time per step from queued CUDA events (the
    graph's with its copies in and out), busy share = device / wall; the
    graph pool's bytes."""
    graphed = st.compiled_step()
    zero = np.zeros(st.n_act)
    zero_t = torch.zeros(st.n_act, dtype=st.dtype, device=st.device)
    c0 = fs._carry
    ce, oe = st.step(c0, zero_t)
    cg, og = graphed(c0, zero_t)
    check = same_bits([(og.y, oe.y), (og.dE, oe.dE), (og.x, oe.x)]
                      + [(getattr(cg, f), getattr(ce, f)) for f in CARRY_FIELDS], path)

    def loop(step, n):
        def run():
            fs._step_compiled = step
            for _ in range(n):
                fs.step(zero)
        return run

    rates = in_turns({"eager": loop(st.step, reps), "graph": loop(graphed, reps)}, reps)
    counts = {"eager": launch_counts(loop(st.step, 10), 10),
              "graph": launch_counts(loop(graphed, 10), 10)}
    fs._step_compiled = graphed
    c = fs._carry
    # one eager step (hundreds of launches on the block path) fills the
    # launch queue behind the sleep; the graph's calls are a few launches
    dev_ms = {"eager": events_ms(lambda: st.step(c, zero_t), reps=1),
              "graph": events_ms(lambda: graphed(c, zero_t), reps=10)}
    return graph_report(tag, f"{path}, single stream, fs.step", rates, counts, dev_ms, check,
                        st.graph_pool_bytes(), 1)


def phase_graph_rollout(st, carry, path: str, tag: str, k_mats=None, y0=None,
                        feedback_sign: float = -1.0, steps: int = BATCH_STEPS - 1) -> dict:
    """A rollout of ``steps`` steps from ``carry`` (past its first step;
    batched, or a single stream): make_rollout_open_loop (``k_mats`` None,
    seeded controls)
    or make_rollout_closed_loop (controllers ``k_mats`` from ``y0``, fed
    ``feedback_sign`` times y)
    against the eager loop of Stepper.step (and the controller's products):
    outputs and final carry held bit for bit; aggregate steps/s in turns;
    host launch calls and device kernels per step; device time per step
    from queued CUDA events around a whole rollout, busy share; the graph
    pool's bytes."""
    lead = tuple(carry.u_n.shape[:-1])
    batch = lead[0] if lead else 1
    dev = st.device
    if k_mats is None:
        gen = torch.Generator(device=dev).manual_seed(9)
        u_seq = 0.1 * torch.randn((steps,) + lead + (st.n_act,), generator=gen, device=dev,
                                  dtype=st.dtype)
        roll = st.make_rollout_open_loop()

        def graph_run():
            c, o = roll(carry, u_seq)
            return c, [o.y, o.dE]

        def eager_run():
            c, ys, des = carry, [], []
            for u in u_seq:
                c, o = st.step(c, u)
                ys.append(o.y)
                des.append(o.dE)
            return c, [torch.stack(ys), torch.stack(des)]
    else:
        mats = [torch.as_tensor(m, dtype=st.dtype, device=dev) for m in k_mats]
        y0 = torch.as_tensor(y0, dtype=st.dtype, device=dev)
        roll = st.make_rollout_closed_loop(steps, feedback_sign)

        def graph_run():
            c, (ys, des, us, _) = roll(carry, mats, y0)
            return c, [ys, des, us]

        def eager_run():
            ad, bd, cd, dd = mats
            c, y, xk = carry, y0, torch.zeros(ad.shape[:-1], dtype=st.dtype, device=dev)
            ys, des, us = [], [], []

            def mv(a, v):
                return torch.einsum("...ij,...j->...i", a, v)

            for _ in range(steps):
                fb = feedback_sign * y
                u = mv(cd, xk) + mv(dd, fb)
                xk = mv(ad, xk) + mv(bd, fb)
                c, o = st.step(c, u)
                y = o.y
                ys.append(y)
                des.append(o.dE)
                us.append(u)
            return c, [torch.stack(ys), torch.stack(des), torch.stack(us)]

    cg, og = graph_run()
    ce, oe = eager_run()
    check = same_bits(list(zip(og, oe)) + [(getattr(cg, f), getattr(ce, f))
                                           for f in CARRY_FIELDS], path)
    del cg, og, ce, oe
    rates = in_turns({"eager": eager_run, "graph": graph_run}, steps * batch)
    counts = {"eager": launch_counts(eager_run, steps), "graph": launch_counts(graph_run, steps)}
    # the eager rollout's launches would overflow the launch queue behind
    # the sleep: its device time is one eager step's (the controller's
    # products aside)
    u0 = torch.zeros(lead + (st.n_act,), dtype=st.dtype, device=dev)
    dev_ms = {"eager": events_ms(lambda: st.step(carry, u0), reps=2),
              "graph": events_ms(graph_run, reps=1) / steps}
    kind = "open" if k_mats is None else "closed"
    return graph_report(tag, f"{path}, B={batch} {kind} loop, {steps} steps", rates, counts,
                        dev_ms, check, st.graph_pool_bytes(), batch)


def spmm_launches(st, steps: int, first: bool) -> list[int]:
    """Kernel S's launches [csr_matmul, csr_residual] in ``steps`` batched
    steps, the first of them (``first``) the borrowed BDF1 step after
    ``init_carry``: init_carry's mass, the borrowed step's f64 residuals
    (csr_matmul: its x accumulates in f64) and its mass; then per step the
    mass, the first refinement sweep's fused residual and a csr_matmul for
    every later sweep."""
    refine = st._refine.get(st._order_idx[2], 0)
    per_step = [1 + max(refine - 1, 0), min(refine, 1)]
    later = steps - int(first)
    return [per_step[0] * later + (st.BORROW_ITERS + 2) * int(first), per_step[1] * later]


def assembled_mass_nnz(st) -> tuple[int, int]:
    """The mass as the element assembly stores it: (entries, nonzero ones)."""
    from flowcontrol_tpu_torch.fem.assembly import to_scipy_csr

    m = to_scipy_csr(st.forms.mass_elements(), st.space.cell_dofs, st.space.n_dofs)
    return m.nnz, int(np.count_nonzero(m.data))


def spmm_bound(a, batch: int, x_bytes: int, out_bytes: int) -> tuple[float, str, float]:
    """S's least time in ms for ``batch`` vectors through the CSR ``a``:
    x read once, out (and b, for the residual: ``out_bytes`` counts both)
    written once, the matrix at its CSR minimum read once (each stored
    nonzero's value and int32 column, the int32 row pointers), and
    2 nnz B operations at the f32 or f64 rate. Returns (ms, what bounds
    it, bytes)."""
    nnz, n_rows, n = a.values().numel(), a.shape[0], a.shape[1]
    nbytes = (x_bytes * batch * n + out_bytes * batch * n_rows
              + nnz * (a.element_size() + 4) + 4 * (n_rows + 1))
    t_ops = 2.0 * nnz * batch / (PEAK_F32_PER_S if a.dtype == torch.float32 else PEAK_F64_PER_S)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def spmm_plan_cost(st) -> tuple[int, int, float]:
    """The tile plans the Stepper's device matrices carry (each built on
    the matrix's first batched product): (count, device bytes, host
    seconds to build them again from the matrices' host arrays, the copies
    to the card included)."""
    from flowcontrol_tpu_torch.ops.spmm import SpmmPlan

    mats = [st._dev["m"], st._dev.get("lvel")]
    mats += list(st._dev.get("a_bc", {}).values()) + list(st._dev.get("a_refine", {}).values())
    mats = [a for a in mats if a is not None and hasattr(a, "spmm_plan")]
    seconds = 0.0
    for a in mats:
        host = (a.crow_indices().cpu().numpy(), a.col_indices().cpu().numpy(),
                a.values().cpu().numpy())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        SpmmPlan.build(*host, a.device)
        torch.cuda.synchronize()
        seconds += time.perf_counter() - t0
    return len(mats), sum(a.spmm_plan.nbytes for a in mats), seconds


def phase_spmm(st, tag: str, batch: int) -> dict:
    """Kernel S on the Stepper's zero-free mass (f32) and BDF2 refinement
    operator (f64) at ``batch``: the tiled kernel bitwise equal to the
    row-wise reference kernel and over two calls, one counted launch per
    call, within 1e-5 (f32) or 1e-12 (f64) of its plain version
    (cuSPARSE's column-major product); the fused residual bitwise equal to
    its composition ``(b.double() - csr_matmul(a, x.double())).to(f32)``
    and within 1e-5 of its plain version (the composition through
    cuSPARSE). Device times (queued events) of each beside the row-wise
    kernel, the plain version, the library's row-major product
    ``a @ x.T.contiguous()`` on the same matrix, the compositions (through
    S and through the row-wise kernel) and the bound on the stored
    nonzeros; the matrices' stored and assembled entries, their plans'
    tiles, longest column lists and bytes; all the Stepper's plans' bytes
    and host build time."""
    from flowcontrol_tpu_torch.fem.assembly import to_scipy_csr
    from flowcontrol_tpu_torch.ops.spmm import (
        csr_matmul,
        csr_matmul_plain,
        csr_matmul_rowwise,
        csr_residual,
        csr_residual_plain,
        plan_of,
    )

    space, oi = st.space, st._order_idx[2]
    raw = to_scipy_csr(st.forms.transient_lhs(2, st.u0_nodes), space.cell_dofs, space.n_dofs)
    stored = {"f32": f"the assembly stores {assembled_mass_nnz(st)[0]}",
              "f64": f"the assembly stores {raw.nnz}, its BC elimination "
                     f"{st.bcs.eliminate_csr(raw)[0].nnz}"}
    gen = torch.Generator(device=st.device).manual_seed(3)
    out = {}
    for name, a in (("f32", st._dev["m"]), ("f64", st._dev["a_refine"][oi])):
        n, plan = a.shape[1], plan_of(a)
        x = torch.randn((batch, n), generator=gen, device=st.device).to(a.dtype)
        before = csr_matmul.launches
        got, again = csr_matmul(a, x), csr_matmul(a, x)
        counted = csr_matmul.launches - before
        ref, plain = csr_matmul_rowwise(a, x), csr_matmul_plain(a, x)
        torch.cuda.synchronize()
        rel, abs_err = rel_err(got, plain)
        same = torch.equal(got, again) and torch.equal(got, ref)
        tol = MF_TOL if a.dtype == torch.float32 else 1e-12
        if not (same and counted == 2 and rel <= tol):
            raise AssertionError(f"{tag}: S {name}: bitwise (two calls, row-wise) {same}, "
                                 f"launches {counted}, error {rel:.3e}")
        bnd, by, nbytes = spmm_bound(a, batch, a.element_size(), a.element_size())
        r = dict(max_abs_err=abs_err, ms=events_ms(lambda: csr_matmul(a, x), reps=10),
                 rowwise_ms=events_ms(lambda: csr_matmul_rowwise(a, x), reps=10),
                 plain_ms=events_ms(lambda: csr_matmul_plain(a, x), reps=10),
                 library_ms=events_ms(lambda: a @ x.T.contiguous(), reps=10), bound_ms=bnd,
                 bound_by=by)
        log(f"{tag}: S {name} B={batch} n={n}: {a.values().numel()} stored nonzeros "
            f"({stored[name]}); plan {plan.n_tiles} tiles, longest column list "
            f"{plan.max_cols}, {plan.staged_cols} staged columns ({plan.staged_cols / n:.2f} n), "
            f"{plan.nbytes / 1e6:.2f} MB; bitwise equal to the row-wise kernel and over two calls; "
            f"max|k-p|/max|p| = {rel:.3e} (tol {tol:g}); device time per call (queued events): "
            f"kernel {r['ms']:.4f} ms, row-wise kernel (with its two layout copies) "
            f"{r['rowwise_ms']:.4f}, plain (cuSPARSE, column-major) {r['plain_ms']:.4f}, library "
            f"(cuSPARSE, row-major) {r['library_ms']:.4f}, bound {bnd:.4f} ms ({by}, "
            f"{nbytes / 1e9:.4f} GB)")
        out[name] = r
    # the fused residual on the operator, f32 x and b
    a = st._dev["a_refine"][oi]
    x = torch.randn((batch, a.shape[1]), generator=gen, device=st.device)
    b = torch.randn((batch, a.shape[0]), generator=gen, device=st.device)

    def composition():
        return (b.double() - csr_matmul(a, x.double())).to(torch.float32)

    def composition_rowwise():
        return (b.double() - csr_matmul_rowwise(a, x.double())).to(torch.float32)

    before = csr_residual.launches
    got, again = csr_residual(a, b, x), csr_residual(a, b, x)
    counted = csr_residual.launches - before
    want, want_rw, plain = composition(), composition_rowwise(), csr_residual_plain(a, b, x)
    torch.cuda.synchronize()
    rel, abs_err = rel_err(got, plain)
    same = torch.equal(got, again) and torch.equal(got, want) and torch.equal(got, want_rw)
    if not (same and counted == 2 and rel <= MF_TOL):
        raise AssertionError(f"{tag}: S residual: bitwise (two calls, compositions) {same}, "
                             f"launches {counted}, error {rel:.3e}")
    bnd, by, nbytes = spmm_bound(a, batch, 4, 8)
    r = dict(max_abs_err=abs_err, ms=events_ms(lambda: csr_residual(a, b, x), reps=10),
             composition_ms=events_ms(composition, reps=10),
             composition_rowwise_ms=events_ms(composition_rowwise, reps=10),
             plain_ms=events_ms(lambda: csr_residual_plain(a, b, x), reps=10), bound_ms=bnd,
             bound_by=by)
    log(f"{tag}: S residual B={batch}: bitwise equal to (b.double() - A x.double()).to(f32) "
        f"through S and through the row-wise kernel, and over two calls; max|k-p|/max|p| = "
        f"{rel:.3e} (tol {MF_TOL:g}); device time per call (queued events): kernel "
        f"{r['ms']:.4f} ms, the composition through S {r['composition_ms']:.4f}, through the "
        f"row-wise kernel {r['composition_rowwise_ms']:.4f}, plain (the composition through "
        f"cuSPARSE) {r['plain_ms']:.4f}, bound {bnd:.4f} ms ({by}, {nbytes / 1e9:.4f} GB)")
    out["residual"] = r
    count, nbytes, seconds = spmm_plan_cost(st)
    log(f"{tag}: S's tile plans: {count} matrices of the Stepper carry one, {nbytes / 1e6:.2f} MB "
        f"on the card in all; built again from the matrices' host arrays in {seconds:.3f} s "
        f"(host, copies to the card included)")
    return out


def base_flow(fs) -> tuple[str, float]:
    """``fs``'s base flow: the committed file when its mesh checksum matches
    this mesh, else its recipe of ``models/make_baseflow.py`` on the host
    (the cavity: Picard (10) + Newton (10); the lid cavity: Newton
    continuation in Re; the pinball: Picard (15) + Newton (10)), and the
    log says which. Returns (source, seconds)."""
    from flowcontrol_tpu_torch.models import make_baseflow
    from flowcontrol_tpu_torch.models.baseflows import committed_baseflow

    t0 = time.perf_counter()
    path = committed_baseflow(fs)
    if path is not None:
        fs.load_steady_state(path)
        return f"loaded {path.name} (mesh checksum matches)", time.perf_counter() - t0
    done, stages = make_baseflow.RECIPES[fs.BASEFLOW_NAME](fs.params_save.path_out)
    fs._assign_steady_state(done.fields.U0, done.fields.P0)
    return (f"computed on the host: {', '.join(name for name, _ in stages)}; no committed "
            f"file matches this mesh's checksum"), time.perf_counter() - t0


CAV_FB_STEPS = 4000  # the JAX example's and its test's horizon (T = 1.6)
CAV_FB_EAGER = 50  # the example's eager loop held against the fused rollout
CAV_FB_RATIO = 0.8  # closed/open energy at CAV_FB_STEPS (tests/integration/test_stock_parity.py:372)
CAV_FB_MARKS = (1000, 2000, 3000, 4000)


def cavity_feedback_phase(fc, stc, counters) -> dict:
    """Phase 44: the open cavity's closed loop on phase 17's solver and
    Stepper (no new factorization): the committed mode, ROM and LQG (the
    mesh checksum checked), the example's initial condition 1e-3 Re(v),
    CAV_FB_STEPS steps open (``make_rollout_open_loop``, u = 0) and closed
    (``closed_loop_fn(..., feedback_sign=+1.0)``, the compensator's
    ``discrete(dt)``) under the graph, and the example's eager loop
    (``fs.step`` + the host ``Controller.step``) for CAV_FB_EAGER steps
    against the fused closed loop. Exact launches on each run (K1 steps + 1,
    F one per solve, nothing else). Returns the launches summed over the
    three runs."""
    from flowcontrol_tpu_torch.examples import run_cavity_feedback as example
    from flowcontrol_tpu_torch.models.baseflows import require_mesh
    from flowcontrol_tpu_torch.models.cavity import (
        cavity_feedback_files,
        load_cavity_controller,
        load_cavity_mode,
    )

    t_phase = time.perf_counter()
    files = cavity_feedback_files(fc.space.n_dofs, fc.params_flow.Re)
    mode, k = load_cavity_mode(fc), load_cavity_controller(fc)
    with np.load(files["rom"], allow_pickle=False) as d:
        require_mesh(files["rom"], d["mesh_sha256"], fc.mesh)
        rom_order, kept = d["A"].shape[0], d["kept"]
    unstable = kept[kept.real > 0]
    log(f"phase 44: {', '.join(p.name for p in files.values())}: the mesh checksum matches "
        f"phase 17's mesh; leading λ = {complex(mode['eig']):.6f}; ROM order {rom_order} "
        f"({len(kept)} kept eigenvalues, unstable {np.round(np.sort_complex(unstable), 4).tolist()})"
        f"; compensator {k.nstates} states, {k.ninputs} inputs, {k.noutputs} output, discrete "
        f"at dt {k.native_dt}")
    dt = fc.params_time.dt
    oi = stc._order_idx[2]
    mf, refine = stc._solvers[oi], stc._refine.get(oi, 0)
    t0 = time.perf_counter()
    for c in counters:
        c.launches = 0
    example.start(fc, mode)  # fc holds phase 17's Stepper: kept, with a new carry
    torch.cuda.synchronize()
    t_start = time.perf_counter() - t0
    kept_factor = fc._stepper is stc and stc._solvers[oi] is mf
    log(f"phase 44: re-initialised on 1e-3 Re(v) in {t_start:.3f} s: phase 17's Stepper "
        f"{'kept, its factor and graphs (nothing built or streamed)' if kept_factor else 'lost'}; "
        f"launches K1/K2/P1/K3/F/S/R {[c.launches for c in counters]} (init_carry's K1)")
    if not kept_factor:
        raise AssertionError("phase 44: re-initialising replaced phase 17's Stepper")
    carry0, y0 = fc._carry, np.asarray(fc.y_meas).copy()

    def expected(steps: int) -> list:
        return [steps + 1, 0, 0, 0, (1 + stc.BORROW_ITERS) + (steps - 1) * (1 + refine), 0, 0]

    runs, total = {}, [0] * len(counters)
    for name in ("open", "closed"):
        if name == "open":
            roll, args = stc.make_rollout_open_loop(), (np.zeros((CAV_FB_STEPS, stc.n_act)),)
        else:
            roll = stc.closed_loop_fn(CAV_FB_STEPS, feedback_sign=+1.0)
            args = (k.discrete(dt), y0)
        for c in counters:
            c.launches = 0
        carry0 = stc.init_carry(carry0.u_n)  # K1 once, as the example's start
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, out = roll(carry0, *args)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = [c.launches for c in counters]
        if name == "open":
            ys, de, us, div = out.y, out.dE, None, out.diverged
        else:
            ys, de, us, div = out
        ys, de = ys.double().cpu().numpy(), de.double().cpu().numpy()
        runs[name] = dict(ys=ys, de=de, us=None if us is None else us.double().cpu().numpy())
        log(f"phase 44 ({name} loop): {CAV_FB_STEPS} steps under the graph in {sec:.2f} s, "
            f"{CAV_FB_STEPS / sec:.2f} steps/s (first capture included); dE "
            + ", ".join(f"{n}: {de[n - 1]:.6e}" for n in CAV_FB_MARKS)
            + (f"; max |u| {np.abs(runs[name]['us']).max():.4e}" if us is not None else "")
            + f"; launches K1/K2/P1/K3/F/S/R {launches} (expected {expected(CAV_FB_STEPS)})")
        if not (np.isfinite(ys).all() and np.isfinite(de).all()) or bool(div.any()):
            raise AssertionError(f"phase 44 ({name} loop): non-finite y or dE")
        if launches != expected(CAV_FB_STEPS):
            raise AssertionError(f"phase 44 ({name} loop): launches {launches}")
        total = [a + b for a, b in zip(total, launches)]
    ratio = {n: runs["closed"]["de"][n - 1] / runs["open"]["de"][n - 1] for n in CAV_FB_MARKS}
    log(f"phase 44: closed/open energy " + ", ".join(f"{n}: {r:.4f}" for n, r in ratio.items())
        + f" (dE at the start {runs['open']['de'][0]:.6e}; open grows "
        f"{runs['open']['de'][-1] / runs['open']['de'][0]:.3f}x over {CAV_FB_STEPS} steps)")
    if len(unstable) and not ratio[CAV_FB_STEPS] < CAV_FB_RATIO:
        raise AssertionError(f"phase 44: closed/open energy {ratio[CAV_FB_STEPS]:.4f} at step "
                             f"{CAV_FB_STEPS}, not below {CAV_FB_RATIO}")

    # the example's eager loop against the fused closed loop
    for c in counters:
        c.launches = 0
    k.reset()
    example.start(fc, mode)
    t0 = time.perf_counter()
    example.run(fc, CAV_FB_EAGER, k)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    ts = fc.timeseries
    y_e = np.stack([ts[f"y_meas_{i + 1}"][1:] for i in range(stc.ns)], 1)
    u_e, de_e = ts["u_ctrl_1"][1:], ts["dE"][1:]
    cl = runs["closed"]
    errs = {"y": rel_err(torch.as_tensor(cl["ys"][:CAV_FB_EAGER]), torch.as_tensor(y_e))[0],
            "u": rel_err(torch.as_tensor(cl["us"][:CAV_FB_EAGER, 0]), torch.as_tensor(u_e))[0],
            "dE": rel_err(torch.as_tensor(cl["de"][:CAV_FB_EAGER]), torch.as_tensor(de_e))[0]}
    log(f"phase 44 (the example's eager loop): {CAV_FB_EAGER} fs.step + Controller.step in "
        f"{sec:.2f} s; against the fused closed loop, relative to each peak: "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (tol {MEMBER_TOL:g}); launches K1/K2/P1/K3/F/S/R {launches} (expected "
        f"{expected(CAV_FB_EAGER)})")
    if not (np.isfinite(y_e).all() and np.isfinite(de_e).all()):
        raise AssertionError("phase 44 (eager): non-finite y or dE")
    if launches != expected(CAV_FB_EAGER):
        raise AssertionError(f"phase 44 (eager): launches {launches}")
    if not max(errs.values()) <= MEMBER_TOL:
        raise AssertionError(f"phase 44: the eager loop differs from the fused one: {errs}")
    total = [a + b for a, b in zip(total, launches)]
    log(f"phase 44: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=total, ratio=ratio[CAV_FB_STEPS])


#: N: the JAX test's Re=100 horizon (test_stock_parity_extra.py:312-313). The
#: committed design's ROM never stays below PIN_FB_RATIO within it (PERF.md
#: §6), so its crossing plus a margin would be past it
PIN_FB_STEPS = 20000
PIN_FB_RATIO = 0.5  # closed/open energy at N (test_stock_parity_extra.py:372-373)
#: what phase 45 holds: the design search on the card found no design that
#: stays bounded below PIN_FB_RATIO (ROADMAP, "Faults in the reference",
#: beside the JAX test's xfail), so the committed design is held below the
#: open loop's energy at N, and the log says whether it reaches PIN_FB_RATIO
PIN_FB_HOLD = 1.0
PIN_FB_EAGER = 50  # the example's eager loop held against the fused rollout


def pinball_feedback_phase(fp, stp, counters) -> dict:
    """Phase 45: the pinball's MIMO closed loop on phase 27's solver and
    Stepper (no new factorization): the committed mode, ROM and LQG (the
    mesh checksum checked), the example's initial condition 2e-4 Re(v),
    PIN_FB_STEPS steps open (u = 0) and closed (``closed_loop_fn(N,
    feedback_sign=+1.0)``, the compensator's ``discrete(dt)``) under the
    graph as one 2-row loop through F, the open row's compensator output
    zeroed; the example's eager loop for PIN_FB_EAGER steps against the
    fused closed loop. Exact launches on each run (K1 steps + 1, F one per
    solve, S's batched sparse products on the 2-row loop, nothing else).
    Returns the launches summed over the runs."""
    from flowcontrol_tpu_torch.examples import run_pinball_feedback as example
    from flowcontrol_tpu_torch.models.baseflows import require_mesh
    from flowcontrol_tpu_torch.models.pinball import (
        load_pinball_controller,
        load_pinball_mode,
        pinball_feedback_files,
    )
    from flowcontrol_tpu_torch.tools.cavity_feedback_synth import rom_energy_ratios
    from flowcontrol_tpu_torch.utils.statespace import StateSpace

    t_phase = time.perf_counter()
    steps = PIN_FB_STEPS
    marks = tuple(steps // 4 * i for i in range(1, 5))
    files = pinball_feedback_files(fp.space.n_dofs, fp.params_flow.Re)
    mode, k = load_pinball_mode(fp), load_pinball_controller(fp)
    with np.load(files["rom"], allow_pickle=False) as d:
        require_mesh(files["rom"], d["mesh_sha256"], fp.mesh)
        rom, kept = StateSpace(d["A"], d["B"], d["C"]), d["kept"]
    unstable = kept[kept.real > 0]
    dt = fp.params_time.dt
    rho = float(np.abs(np.linalg.eigvals(k.A)).max())
    rom_ratio = rom_energy_ratios(rom, k, kept, dt=dt, steps=marks)
    log(f"phase 45: {', '.join(p.name for p in files.values())}: the mesh checksum matches "
        f"phase 27's mesh; leading λ = {complex(mode['eig']):.6f}; ROM order {rom.nstates} "
        f"({len(kept)} kept eigenvalues, unstable {np.round(np.sort_complex(unstable), 4).tolist()})"
        f"; compensator {k.nstates} states, {k.ninputs} inputs, {k.noutputs} outputs, discrete "
        f"at dt {k.native_dt}, its own spectral radius {rho:.6f}; the ROM's closed/open energy "
        + ", ".join(f"{n}: {r:.4g}" for n, r in rom_ratio.items()))
    oi = stp._order_idx[2]
    mf, refine = stp._solvers[oi], stp._refine.get(oi, 0)
    t0 = time.perf_counter()
    for c in counters:
        c.launches = 0
    example.start(fp, mode)  # fp holds phase 27's Stepper: kept, with a new carry
    torch.cuda.synchronize()
    t_start = time.perf_counter() - t0
    kept_factor = fp._stepper is stp and stp._solvers[oi] is mf
    log(f"phase 45: re-initialised on {example.ic_amplitude(fp.params_flow.Re):g} Re(v) in "
        f"{t_start:.3f} s: phase 27's Stepper "
        f"{'kept, its factor and graphs (nothing built)' if kept_factor else 'lost'}; "
        f"launches K1/K2/P1/K3/F/S/R {[c.launches for c in counters]} (init_carry's K1)")
    if not kept_factor:
        raise AssertionError("phase 45: re-initialising replaced phase 27's Stepper")
    carry0, y0 = fp._carry, np.asarray(fp.y_meas).copy()

    def expected(n: int, rows: int = 1) -> list:
        # a batch's sparse products are S's (csr_matmul, csr_residual)
        s_counts = spmm_launches(stp, n, True) if rows > 1 else [0, 0]
        return [n + 1, 0, 0, 0, (1 + stp.BORROW_ITERS) + (n - 1) * (1 + refine), *s_counts]

    # row 0 the open loop (the compensator's C = D = 0), row 1 the closed
    kd = k.discrete(dt)
    mats = tuple(np.stack([m * (0.0 if i >= 2 else 1.0), m]) for i, m in enumerate(kd))
    roll = stp.closed_loop_fn(steps, feedback_sign=+1.0)
    for c in counters:
        c.launches = 0
    carry = stp.init_carry(carry0.u_n.expand(2, -1).contiguous())  # K1 once, as start's
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, (ys, de, us, div) = roll(carry, mats, np.stack([y0, y0]))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    want = expected(steps, 2)
    ys, de, us = (t.double().cpu().numpy() for t in (ys, de, us))
    runs = {"open": dict(ys=ys[:, 0], de=de[:, 0]),
            "closed": dict(ys=ys[:, 1], de=de[:, 1], us=us[:, 1])}
    log(f"phase 45 (open+closed loop): {steps} steps under the graph in {sec:.2f} s, "
        f"{steps / sec:.2f} steps/s a row (first capture included); dE "
        + "; ".join(f"{r}: " + ", ".join(f"{n}: {runs[r]['de'][n - 1]:.6e}" for n in marks)
                    for r in runs)
        + f"; max |u| {np.abs(us[:, 1]).max():.4e}; launches K1/K2/P1/K3/F/S/R {launches} "
        f"(expected {want})")
    if np.abs(us[:, 0]).max() != 0.0:
        raise AssertionError("phase 45: the open row was actuated")
    if not (np.isfinite(ys).all() and np.isfinite(de).all()) or bool(div.any()):
        raise AssertionError("phase 45 (open+closed loop): non-finite y or dE")
    if launches != want:
        raise AssertionError(f"phase 45 (open+closed loop): launches {launches}")
    total = launches
    ratio = {n: runs["closed"]["de"][n - 1] / runs["open"]["de"][n - 1] for n in marks}
    log(f"phase 45: closed/open energy " + ", ".join(f"{n}: {r:.4f}" for n, r in ratio.items())
        + f" (dE at the start {runs['open']['de'][0]:.6e}; open grows "
        f"{runs['open']['de'][-1] / runs['open']['de'][0]:.3f}x over {steps} steps)")
    log(f"phase 45: closed/open energy {ratio[steps]:.4f} at step {steps}: "
        f"{'below' if ratio[steps] < PIN_FB_RATIO else 'not below'} the JAX test's "
        f"{PIN_FB_RATIO}; held below {PIN_FB_HOLD}")
    if len(unstable) and not ratio[steps] < PIN_FB_HOLD:
        raise AssertionError(f"phase 45: closed/open energy {ratio[steps]:.4f} at step "
                             f"{steps}, not below {PIN_FB_HOLD}")

    # the example's eager loop against the fused closed loop
    for c in counters:
        c.launches = 0
    k.reset()
    example.start(fp, mode)
    t0 = time.perf_counter()
    example.run(fp, PIN_FB_EAGER, k)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    ts = fp.timeseries
    y_e = np.stack([ts[f"y_meas_{i + 1}"][1:] for i in range(stp.ns)], 1)
    u_e = np.stack([ts[f"u_ctrl_{i + 1}"][1:] for i in range(stp.n_act)], 1)
    de_e = ts["dE"][1:]
    cl = runs["closed"]
    errs = {"y": rel_err(torch.as_tensor(cl["ys"][:PIN_FB_EAGER]), torch.as_tensor(y_e))[0],
            "u": rel_err(torch.as_tensor(cl["us"][:PIN_FB_EAGER]), torch.as_tensor(u_e))[0],
            "dE": rel_err(torch.as_tensor(cl["de"][:PIN_FB_EAGER]), torch.as_tensor(de_e))[0]}
    log(f"phase 45 (the example's eager loop): {PIN_FB_EAGER} fs.step + Controller.step in "
        f"{sec:.2f} s; against the fused closed loop, relative to each peak: "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (tol {MEMBER_TOL:g}); launches K1/K2/P1/K3/F/S/R {launches} (expected "
        f"{expected(PIN_FB_EAGER)})")
    if not (np.isfinite(y_e).all() and np.isfinite(de_e).all()):
        raise AssertionError("phase 45 (eager): non-finite y or dE")
    if launches != expected(PIN_FB_EAGER):
        raise AssertionError(f"phase 45 (eager): launches {launches}")
    if not max(errs.values()) <= MEMBER_TOL:
        raise AssertionError(f"phase 45: the eager loop differs from the fused one: {errs}")
    total = [a + b for a, b in zip(total, launches)]
    log(f"phase 45: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=total, ratio=ratio[steps], steps=steps)


def kernel_row(name, source, replaces, launches, r, library_ms, **extra) -> dict:
    """One kernel's entry of the kernels line."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": library_ms, **extra}


# ── The lid-driven cavity and the fluidic pinball (phases 23-33) ──────────────

LID_RE = 8000
LID_NDOFS = 74_371
LID_U = 0.05  # the lid's perturbation for its first CTRL_STEPS steps
LID_BATCH = 8  # examples/lidcavity_workflows.py batch_run: B = 8, 50 steps
LID_BATCH_STEPS = 50
PIN_RE = 100
PIN_NDOFS = 67_920
LIFT_TOL = 5e-2  # top and bottom lift antisymmetric (tests/integration/test_pinball.py)
DENSE_STEPS = 60  # the pinball's dense path: steps/s over the last DENSE_STEPS - CTRL_STEPS
DENSE_HELD_MAX = 1e9  # bytes the card may hold from earlier phases when phase 32 starts
DENSE_HOLD = 20e9  # bytes held while phase 32 reads the dense rule a third time
# the LQG's closed loop on the generated mesh: the compensator's own
# spectral radius is 4.50 a step, and the full-order plant does not hold it
# (u grows ~4.5x a step: |u| 2.2 at step 6, 372 at step 10, and the state
# overflows within ~20 steps, on the host in f64), so it closes the loop
# for LQG_STEPS steps
LQG_STEPS = 6


def factor_report(tag: str, st, run: dict) -> None:
    """The multifrontal factor of a new flow: host split, stages, stack
    bytes, max_front and F's grid and shared memory at rows 1 and 8."""
    from flowcontrol_tpu_torch.ops.mf_fused import (
        F_BLOCK_THREADS,
        fused_grid,
        fused_smem_bytes,
        grid_syncs,
    )

    mf = st._solvers[st._order_idx[2]]
    t = mf.timings
    log(f"{tag}: solve kinds {st._solver_kinds} (expected ['borrowed', 'multifrontal']), dtype "
        f"{st.dtype}, refinement sweeps {st._refine}; host multifrontal s: ordering+f64 "
        f"factorization {t['ordering+factorization']:.2f}, repack {t['repack']:.2f}, error probe "
        f"{t['measure_err']:.2f}, tables {t['tables']:.2f}, upload {t['upload']:.2f}, total "
        f"{t['total']:.2f}; factorization+init_carry {run['t_factor']:.2f}; peak device memory "
        f"{run['peak_gb']:.2f} GB")
    log(f"{tag}: {len(mf.stages)} stages (cylinder 19, open cavity 24), factor stacks "
        f"{mf.factor_bytes / 1e9:.4f} GB (cylinder 0.459, open cavity 0.877), {mf.total_slots} "
        f"slots, {mf.total_contrib} contributions, up to "
        f"{max(len(s.segs) for s in mf.stages)} inbox segments a stage; measured per-solve error "
        f"{mf.solve_err:.3e} (zero-sweep ceiling {mf.ZERO_SWEEP_ERR:g}); (m, e, b) per stage "
        f"{[(s.m, s.e, s.b) for s in mf.stages]}")
    for rows in (1, 8):
        g = fused_grid(rows, mf.max_front, len(mf.stages))
        log(f"{tag}: F rows={rows}: node vectors of max_front {mf.max_front} floats, "
            f"{fused_smem_bytes(mf, rows)} bytes of shared memory a block, grid {g['blocks']} "
            f"blocks of {F_BLOCK_THREADS} threads ({g['per_sm']} per SM x {g['sms']} SMs), "
            f"{grid_syncs(mf)} grid syncs")


def expect_launches(tag: str, got: list, want: list, what: str) -> None:
    """Logs the launch counts of a run and fails unless they are ``want``."""
    log(f"{tag}: launches K1/K2/P1/K3/F/S/R {got} (expected {want}: {what})")
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, expected {want}")


def phase_lid_batch(fs, st, counters, tag: str) -> dict:
    """``batch_run``'s traffic (examples/lidcavity_workflows.py): LID_BATCH
    copies of the state, each plus 1e-3 times seed-0 normal noise, zero
    control, LID_BATCH_STEPS steps of ``rollout_open_loop`` through F at
    LID_BATCH rows (the launches counted); member 0 against its
    single-stream run. The rate of the first rollout (S's plans and the
    capture inside) and of a second one from the same states."""
    up = fs._carry.u_n.double().cpu().numpy()
    rng = np.random.default_rng(0)
    batch = up[None, :] + 1e-3 * rng.standard_normal((LID_BATCH, up.shape[0]))
    u_seq = np.zeros((LID_BATCH_STEPS, LID_BATCH, st.n_act))

    def rollout():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, outs = st.rollout_open_loop(st.init_carry(batch), u_seq)
        torch.cuda.synchronize()
        return outs, LID_BATCH_STEPS * LID_BATCH / (time.perf_counter() - t0)

    for c in counters:
        c.launches = 0
    outs, first = rollout()
    launches = [c.launches for c in counters]
    rates = [first, rollout()[1]]
    if not (bool(torch.isfinite(outs.y).all() and torch.isfinite(outs.dE).all())
            and not bool(outs.diverged.any())):
        raise AssertionError(f"{tag}: a batch member is not finite")
    _, one = st.rollout_open_loop(st.init_carry(batch[0]), u_seq[:, 0])
    err = rel_err(outs.y[:, 0], one.y)[0]
    de = outs.dE[-1].double().cpu().numpy()
    log(f"{tag}: B={LID_BATCH}, {LID_BATCH_STEPS} steps through F at {LID_BATCH} rows: "
        f"{rates[0]:.1f} aggregate steps/s with S's first plans and the capture, {rates[1]:.1f} "
        f"in a second rollout ({card_line()}); final dE per member "
        f"{np.array2string(de, precision=4)}; member 0 against its single-stream run: y "
        f"max|b-s|/max|s| {err:.3e} (tol {MEMBER_TOL:g})")
    if not err <= MEMBER_TOL:
        raise AssertionError(f"{tag}: member 0 against its single-stream run: {err:.3e}")
    return dict(sps=rates[1], launches=launches)


def lqg_population(k, dt: float):
    """The LQG compensator ``k`` (discrete-native) at BATCH gains
    ``linspace(0.5, 1.5)`` on its output: a controller search's traffic.
    Returns (gains, stacked f32 k_mats)."""
    ad, bd, cd, dd = k.discrete(dt, dtype=np.float32)
    gains = np.linspace(0.5, 1.5, BATCH, dtype=np.float32)
    return gains, (np.tile(ad, (BATCH, 1, 1)), np.tile(bd, (BATCH, 1, 1)),
                   gains[:, None, None] * cd, gains[:, None, None] * dd)


def phase_pinball_batch(fs, st, k, counters, tag: str) -> dict:
    """BATCH copies of the pinball's state, each with the LQG at its gain,
    through ``init_carry`` + ``rollout_closed_loop(..., feedback_sign=+1)``
    for LQG_STEPS steps (the per-stage sweep: K2, P1 and S); member 0
    against a single-stream ``Controller.step`` + ``fs.step`` loop at its
    gain."""
    from flowcontrol_tpu_torch.core.controller import Controller

    dt = fs.params_time.dt
    gains, k_mats = lqg_population(k, dt)
    up = fs._carry.u_n.double().cpu().numpy()
    y0 = np.tile(fs.y_meas, (BATCH, 1))
    up_b = torch.as_tensor(up, dtype=st.dtype, device=st.device).expand(BATCH, -1).contiguous()
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, (ys, des, us, divs) = st.rollout_closed_loop(st.init_carry(up_b), k_mats, y0,
                                                        LQG_STEPS, feedback_sign=1.0)
    torch.cuda.synchronize()
    sps = LQG_STEPS * BATCH / (time.perf_counter() - t0)
    launches = [c.launches for c in counters]
    spread = float((us[:, 0] - us[:, -1]).abs().max())
    if not (bool(torch.isfinite(des).all() and torch.isfinite(ys).all()) and spread > 0
            and not bool(divs.any()) and us.shape == (LQG_STEPS, BATCH, 3)):
        raise AssertionError(f"{tag}: closed-loop rollout not finite, or u equal across members")
    ad, bd, cd, dd = k.discrete(dt)
    k0 = Controller.from_matrices(A=ad, B=bd, C=float(gains[0]) * cd, D=float(gains[0]) * dd,
                                  dt=dt)
    fs._carry = st.init_carry(up)
    y, ys1, us1 = fs.y_meas.copy(), [], []
    for _ in range(LQG_STEPS):
        u = k0.step(y, dt)
        y = fs.step(u_ctrl=u)
        ys1.append(y)
        us1.append(u)
    err_y = rel_err(ys[:, 0].double().cpu(), torch.as_tensor(np.asarray(ys1)))[0]
    err_u = rel_err(us[:, 0].double().cpu(), torch.as_tensor(np.asarray(us1)))[0]
    log(f"{tag}: B={BATCH} LQG gains, {LQG_STEPS} steps: {sps:.1f} aggregate steps/s (the "
        f"first capture and S's first plans included); dE finite, at the last step "
        f"{float(des[-1].min()):.3e} to {float(des[-1].max()):.3e}; max|u| "
        f"{float(us.abs().max()):.3e}, u of members 0 and {BATCH - 1} differ by {spread:.3e}; "
        f"member 0 against the single-stream Controller.step + fs.step loop (gain "
        f"{float(gains[0]):g}), relative: y {err_y:.3e}, u {err_u:.3e} (tol {MEMBER_TOL:g})")
    if not max(err_y, err_u) <= MEMBER_TOL:
        raise AssertionError(f"{tag}: member 0 against its single-stream loop: {err_y}, {err_u}")
    return dict(sps=sps, launches=launches, carry=carry, y_last=ys[-1], k_mats=k_mats)


def graph_summary(graphs: dict, tag: str, card: str) -> None:
    """One line per graph phase: eager and graph steps/s, busy shares, host
    launch calls, the replay's check and the pool."""
    for name, g in graphs.items():
        log(f"{tag}: {name}: eager {np.mean(g['rates']['eager']):.1f}, graph "
            f"{np.mean(g['rates']['graph']):.1f} steps/s (graph / eager "
            f"{np.mean(g['rates']['graph']) / np.mean(g['rates']['eager']):.3f}); busy share "
            f"eager {g['busy']['eager']:.3f}, graph {g['busy']['graph']:.3f}; host launch calls "
            f"per step {g['host'][0]:.1f} -> {g['host'][1]:.1f}; replay {g['check']}; pool "
            f"{g['pool'] / 1e6:.1f} MB ({card})")


def free_card() -> None:
    """Collect what the dropped solvers held and give the cached blocks back
    to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def new_flows(counters, card: str, child: FactorChild) -> tuple[list, list, dict]:
    """Phases 23-33 and 45: the lid-driven cavity and the fluidic pinball at
    their default meshes, their factors streamed from ``child``'s host
    build. Returns kernel S's launches there ([csr_matmul, csr_residual]),
    their rows of the kernels line and phase 45's result."""
    from flowcontrol_tpu_torch.core.actuator import CYLINDER_ACTUATION_MODE
    from flowcontrol_tpu_torch.core.controller import Controller
    from flowcontrol_tpu_torch.core.stepper import dense_lu_max_dofs_device
    from flowcontrol_tpu_torch.models.pinball import PINBALL_LQG_RE100, PinballFlowSolver

    dev = torch.device("cuda", 0)
    graphs = {}

    # ── phase 23: the lid-driven cavity, single stream ───────────────────────
    t0 = time.perf_counter()
    fl = lid_solver("cuda")
    t_mesh = time.perf_counter() - t0
    if fl.space.n_dofs != LID_NDOFS:
        raise AssertionError(f"lid cavity default mesh has {fl.space.n_dofs} dofs, expected "
                             f"{LID_NDOFS}")
    src, t_base = base_flow(fl)
    fl.initialize_time_stepping()
    lid = streamed(child, "lidcavity", "phase 23", lambda: run_path(fl, counters, u_on=(LID_U,)))
    stl = lid["st"]
    oil = stl._order_idx[2]
    mfl = stl._solvers[oil]
    pin = 2 * fl.space.n_vnodes
    log(f"phase 23: lid cavity Re={LID_RE}: mesh {fl.mesh.num_cells} cells, {fl.space.n_dofs} "
        f"dofs ({fl.space.n_vel_dofs} velocity + {fl.space.n_pressure_dofs} pressure); mesh+spaces "
        f"{t_mesh:.2f} s; base flow {src} in {t_base:.2f} s, max|U0| "
        f"{np.abs(fl.fields.U0).max():.6f}; pressure dof {pin} pinned: {pin in stl.bcs.dofs}")
    factor_report("phase 23", stl, lid)
    log(f"phase 23: {NUM_STEPS} steps (u = [{LID_U}] for {CTRL_STEPS}, then 0), single-stream "
        f"{lid['sps']:.2f} steps/s over the last {NUM_STEPS - CTRL_STEPS} ({card}); y[-1] = "
        f"{lid['ys'][-1].tolist()}, dE[-1] = {lid['de'][-1]:.6e}")
    solves = (1 + stl.BORROW_ITERS) + (NUM_STEPS - 1) * (1 + stl._refine.get(oil, 0))
    expect_launches("phase 23", lid["launches"], [NUM_STEPS + 1, 0, 0, 0, solves, 0, 0],
                    f"{solves} solves, each one launch of F")
    if (pin not in stl.bcs.dofs or stl._solver_kinds != ["borrowed", "multifrontal"]
            or fl.params_solver.stepper_options or not mfl.takes_fused(1)):
        raise AssertionError(f"lid cavity: pin {pin in stl.bcs.dofs}, kinds {stl._solver_kinds}")

    # ── phase 24: F against plain on the lid cavity's factor ─────────────────
    f_lid = phase_fused(mfl, "phase 24")

    # ── phase 25: accuracy against host f64; the graph against eager ─────────
    accuracy(HostF64Loop(fl), stl, lid["carry10"], "phase 25")
    graphs["lid cavity multifrontal B=1"] = phase_graph_single(fl, stl, "multifrontal",
                                                               "phase 25g")

    # ── phase 26: batch_run's traffic through F at LID_BATCH rows ────────────
    lidb = phase_lid_batch(fl, stl, counters, "phase 26")
    solves_b = (1 + stl.BORROW_ITERS) + (LID_BATCH_STEPS - 1) * (1 + stl._refine.get(oil, 0))
    expect_launches("phase 26", lidb["launches"],
                    [LID_BATCH_STEPS + 1, 0, 0, 0, solves_b,
                     *spmm_launches(stl, LID_BATCH_STEPS, True)],
                    f"{solves_b} solves, each one launch of F at {LID_BATCH} rows")
    k1_lid = phase_kernel(fl.space, fl.geom, dev, widths=(1,), tag="phase 26")
    n_lid = mfl.n
    del fl, stl, mfl, lid["st"]
    free_card()

    # ── phase 27: the pinball, single-stream MIMO closed loop ────────────────
    t0 = time.perf_counter()
    fp = pinball_solver("cuda")
    t_mesh = time.perf_counter() - t0
    if fp.space.n_dofs != PIN_NDOFS:
        raise AssertionError(f"pinball default mesh has {fp.space.n_dofs} dofs, expected "
                             f"{PIN_NDOFS}")
    src, t_base = base_flow(fp)
    coeffs = fp.compute_force_coefficients(fp.fields.U0, fp.fields.P0)
    (cl_top, cd_top), (cl_bot, cd_bot) = coeffs["actuator_top"], coeffs["actuator_bot"]
    log(f"phase 27: pinball Re={PIN_RE}: mesh {fp.mesh.num_cells} cells, {fp.space.n_dofs} dofs; "
        f"mesh+spaces {t_mesh:.2f} s; base flow {src} in {t_base:.2f} s; force coefficients "
        + ", ".join(f"{k} Cl {cl:.6f} Cd {cd:.6f}" for k, (cl, cd) in coeffs.items())
        + f"; top + bottom lift {cl_top + cl_bot:.3e} (tol {LIFT_TOL:g})")
    if not (abs(cl_top + cl_bot) <= LIFT_TOL and cd_top > 0 and cd_bot > 0):
        raise AssertionError(f"pinball lift not antisymmetric: {cl_top}, {cl_bot}")
    # the example's initial condition where no mode file fits the mesh
    # (examples/run_pinball_feedback.py)
    fp.params_ic.xloc, fp.params_ic.yloc = 1.0, 0.0
    fp.params_ic.radius, fp.params_ic.amplitude = 0.6, 0.01
    fp.initialize_time_stepping()
    k = Controller.from_file(PINBALL_LQG_RE100)
    dt = fp.params_time.dt

    def lqg(i, y):  # u = +K(y) for LQG_STEPS steps, then the loop is opened
        return k.step(y, dt) if i < LQG_STEPS else np.zeros(3)

    pinr = streamed(child, "pinball", "phase 27", lambda: run_path(fp, counters, control=lqg))
    stp = pinr["st"]
    oip = stp._order_idx[2]
    mfp = stp._solvers[oip]
    de = pinr["de"]
    rho = float(np.abs(np.linalg.eigvals(k.A)).max())
    log(f"phase 27: MIMO LQG ({k.nstates} states, {k.noutputs} x {k.ninputs}, discrete at dt "
        f"{k.native_dt}, its own spectral radius {rho:.4f}), u = +K(y) through Controller.step + "
        f"fs.step for {LQG_STEPS} steps, then u = 0, {NUM_STEPS} steps in all: single-stream "
        f"{pinr['sps']:.2f} steps/s over the last {NUM_STEPS - CTRL_STEPS} ({card}); |u| per "
        f"closed-loop step {np.abs(pinr['us'][:LQG_STEPS]).max(axis=1).round(6).tolist()}; dE "
        f"over the closed loop {de[:LQG_STEPS].tolist()} (measured, not held: the compensator "
        f"was synthesized on the stock mesh), dE[-1] {de[-1]:.6e}; y[-1] = "
        f"{pinr['ys'][-1].tolist()}")
    factor_report("phase 27", stp, pinr)
    solves = (1 + stp.BORROW_ITERS) + (NUM_STEPS - 1) * (1 + stp._refine.get(oip, 0))
    expect_launches("phase 27", pinr["launches"], [NUM_STEPS + 1, 0, 0, 0, solves, 0, 0],
                    f"{solves} solves, each one launch of F")
    if stp._solver_kinds != ["borrowed", "multifrontal"] or not mfp.takes_fused(1):
        raise AssertionError(f"pinball solve kinds {stp._solver_kinds}")

    # ── phase 28: F against plain on the pinball's factor ────────────────────
    f_pin = phase_fused(mfp, "phase 28")

    # ── phase 29: accuracy against host f64; the graph against eager ─────────
    accuracy(HostF64Loop(fp), stp, pinr["carry10"], "phase 29")
    graphs["pinball multifrontal B=1"] = phase_graph_single(fp, stp, "multifrontal", "phase 29g")

    # ── phase 30: BATCH LQG gains through the per-stage sweep ────────────────
    pinb = phase_pinball_batch(fp, stp, k, counters, "phase 30")
    k2p, p1p = mfp.launches_per_solve()
    refine = stp._refine.get(oip, 0)
    solves_b = (1 + stp.BORROW_ITERS) + (LQG_STEPS - 1) * (1 + refine)
    expect_launches("phase 30", pinb["launches"],
                    [LQG_STEPS + 1, solves_b * k2p, solves_b * p1p, 0, 0,
                     *spmm_launches(stp, LQG_STEPS, True)],
                    f"{solves_b} solves x {k2p} K2 and {p1p} P1")
    graphs[f"pinball multifrontal B={BATCH} closed (LQG)"] = phase_graph_rollout(
        stp, pinb["carry"], "multifrontal", "phase 30g", k_mats=pinb["k_mats"],
        y0=pinb["y_last"], feedback_sign=1.0, steps=LQG_STEPS - 1)

    # ── phase 31: K2 and P1 at the pinball's B = BATCH; K1 on its mesh ───────
    k2_pin = phase_k2_wide(mfp, BATCH, "phase 31")
    p1_pin = phase_p1(mfp, BATCH, 1 + refine, "phase 31")
    k1_pin = phase_kernel(fp.space, fp.geom, dev, widths=(1,), tag="phase 31")

    # ── phase 45: the pinball's MIMO closed loop on phase 27's Stepper (no
    # new factorization): the LQG synthesized at this mesh, N steps open and
    # closed
    pin_fb = pinball_feedback_phase(fp, stp, counters)
    n_pin, mf_sps, pin_b_launches = mfp.n, pinr["sps"], pinb["launches"]
    u0, p0 = fp.fields.U0, fp.fields.P0
    del fp, stp, mfp, pinb, pinr["st"]
    free_card()

    # ── phase 32: the dense rule at the pinball's width ──────────────────────
    limit = dense_lu_max_dofs_device(dev)
    fd = PinballFlowSolver.make_default(Re=PIN_RE, num_steps=DENSE_STEPS, device="cuda",
                                        mode_actuation=CYLINDER_ACTUATION_MODE.ROTATION)
    fd._assign_steady_state(u0, p0)
    fd.params_ic.xloc, fd.params_ic.yloc = 1.0, 0.0
    fd.params_ic.radius, fd.params_ic.amplitude = 0.6, 0.01
    fd.initialize_time_stepping()
    k.reset()
    free_b, total_b = torch.cuda.mem_get_info(dev)
    held = torch.cuda.memory_allocated(dev)
    if held > DENSE_HELD_MAX:  # the phase measures what the dense path alone allocates
        raise AssertionError(f"phase 32: {held / 1e9:.2f} GB already on the card")
    dense = run_path(fd, counters, control=lqg, steps=DENSE_STEPS)
    std = dense["st"]
    log(f"phase 32: the dense rule (dense_lu_max_dofs_device) allows {limit} dofs on this card "
        f"({total_b / 1e9:.2f} GB, {free_b / 1e9:.2f} GB free and {held / 1e9:.3f} GB allocated "
        f"before); 'auto' at {PIN_NDOFS} dofs "
        f"took {std._solver_kinds} ({type(std._solvers[-1]).__name__}); peak device memory of "
        f"the factorization and init_carry {dense['peak_gb']:.2f} GB (A and LU in f64, 16 n^2 = "
        f"{16 * PIN_NDOFS ** 2 / 1e9:.2f} GB): it fits; factorization+init_carry "
        f"{dense['t_factor']:.2f} s; {DENSE_STEPS} steps of the LQG loop, single-stream "
        f"{dense['sps']:.2f} steps/s over the last {DENSE_STEPS - CTRL_STEPS} against the "
        f"multifrontal path's {mf_sps:.2f} ({card})")
    expect_launches("phase 32", dense["launches"], [DENSE_STEPS + 1, 0, 0, 0, 0, 0, 0],
                    "the dense LU: K1 only")
    del fd, std, dense
    gc.collect()  # the factorization's blocks stay in PyTorch's cache
    free_c = torch.cuda.mem_get_info(dev)[0]
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    limit_cached = dense_lu_max_dofs_device(dev)
    log(f"phase 32: the dense solver dropped, its blocks cached ({free_c / 1e9:.2f} GB free, "
        f"{cached / 1e9:.2f} GB cached unused): the dense rule allows {limit_cached} dofs")
    if not limit_cached >= PIN_NDOFS:
        raise AssertionError(f"phase 32: with the dropped factorization cached the dense rule "
                             f"allows {limit_cached} < {PIN_NDOFS} dofs")
    free_card()
    hold = torch.empty(int(DENSE_HOLD), dtype=torch.uint8, device=dev)
    limit_held = dense_lu_max_dofs_device(dev)
    log(f"phase 32: with {DENSE_HOLD / 1e9:.0f} GB held ({torch.cuda.mem_get_info(dev)[0] / 1e9:.2f} "
        f"GB free) the dense rule allows {limit_held} dofs (clean card: {limit}): 'auto' at "
        f"{PIN_NDOFS} dofs takes the multifrontal solve")
    if not limit_held < PIN_NDOFS:
        raise AssertionError(f"phase 32: with {DENSE_HOLD / 1e9:.0f} GB held the dense rule "
                             f"still allows {limit_held} >= {PIN_NDOFS} dofs")
    del hold
    free_card()

    # ── phase 33: the new graph phases in sum ────────────────────────────────
    graph_summary(graphs, "phase 33", card)

    src = "flowcontrol_tpu_torch/csrc/"
    k1, k2 = "flowcontrol_tpu/ops/pallas_nl.py:136", "flowcontrol_tpu/ops/pallas_mf_matvec.py:79"
    f_tpu, p1_tpu = "flowcontrol_tpu/solvers/multifrontal.py:1202", "tools/pallas_gather_probe.py:50"
    s_launches = [lidb["launches"][k] + pin_b_launches[k] + pin_fb["launches"][k]
                  for k in (5, 6)]
    return s_launches, [
        kernel_row("K1 nl_convection lid cavity", src + "nl_convection.cu", k1,
                   lid["launches"][0], k1_lid, None),
        kernel_row("K1 nl_convection pinball", src + "nl_convection.cu", k1,
                   pinr["launches"][0], k1_pin, None),
        kernel_row(f"K2 stack_matvec B={BATCH} pinball", src + "mf_sweep.cu", k2,
                   pin_b_launches[1], k2_pin, k2_pin["library_ms"]),
        kernel_row(f"P1 sweep_gather B={BATCH} pinball", src + "mf_sweep.cu", p1_tpu,
                   pin_b_launches[2], p1_pin, p1_pin["library_ms"],
                   **{k: p1_pin[k] for k in P1_EXTRA}),
        kernel_row(f"F multifrontal_solve_fused lid cavity n={n_lid}", src + "mf_fused.cu", f_tpu,
                   lid["launches"][4] + lidb["launches"][4], f_lid, None,
                   sweep_ms=f_lid["sweep_ms"]),
        kernel_row(f"F multifrontal_solve_fused pinball n={n_pin}", src + "mf_fused.cu", f_tpu,
                   pinr["launches"][4] + pin_fb["launches"][4], f_pin, None,
                   sweep_ms=f_pin["sweep_ms"], phase45_launches=pin_fb["launches"][4]),
    ], pin_fb


# ── The analysis path (phases 34-36) ──────────────────────────────────────────

SIGMA = 0.1 + 0.8j  # the shift of examples/compute_eigenvalues.py
# the JAX package's leading eigenvalue on this mesh: host f64 Picard(3) +
# Newton base flow, get_A(autodiff=False), get_mat_vp_shift_invert(n=8,
# sigma=SIGMA) on the CPU
EIG_REF = 0.13292280716306798 + 0.7700283037629039j
EIG_REF_TOL = 1e-6
EIG_DEV_TOL = 1e-2  # tests/test_linalg.py:98
#: in the example's logspace(-1, 1, 50) range, at the mode (one ω: each
#: more costs ~19.5 s of host splu and complex64 LU; the run's time limit)
FREQ_WW = (0.77,)
#: eigenvalues phase 35's host ARPACK call asks for: 2, where the example
#: asks for 8 (the 6 more cost ~75 s of host ARPACK on this mesh, which
#: phase 43 needs to keep the run inside its time limit; the leading one,
#: held against EIG_REF, is the same)
EIG_HOST_N = 2
FREQ_TOL = 2e-4  # tests/test_linalg.py:59
ANALYSIS_SLACK = 1e9  # bytes beyond the matrix and its LU (CSR copies, vectors, workspace)


def analysis(u0: np.ndarray, p0: np.ndarray, card: str) -> tuple:
    """Phases 34-36: operators, eigenvalues and the frequency response of
    the default cylinder around phase 3's base flow. Returns (A, E, B, C,
    the host's H at FREQ_WW) for phases 37-39."""
    from flowcontrol_tpu_torch.core.operatorgetter import OperatorGetter
    from flowcontrol_tpu_torch.fem.assembly import steady_jacobian_elements_autodiff
    from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver
    from flowcontrol_tpu_torch.utils.linalg import (
        eig_arnoldi_dense_device,
        get_frequency_response,
        get_frequency_response_device,
        get_mat_vp_shift_invert,
    )

    dev = torch.device("cuda", 0)
    t_phases = time.perf_counter()
    held = torch.cuda.memory_allocated(dev)
    if held > DENSE_HELD_MAX:
        raise AssertionError(f"phase 34: {held / 1e9:.2f} GB already on the card")

    # ── phase 34: A, E, B, C; the autodiff A on the card ─────────────────────
    fa = CylinderFlowSolver.make_default(Re=RE, num_steps=1, device="cuda")
    fa._assign_steady_state(u0, p0)
    og = OperatorGetter(fa)
    t0 = time.perf_counter()
    a, e, b, c = og.get_all(autodiff=False)
    t_all = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    a_ad = og.get_A(autodiff=True)
    t_ad = time.perf_counter() - t0
    ad_err = abs(a_ad - a).max() / abs(a).max()
    n = a.shape[0]
    up0 = torch.as_tensor(fa.fields.UP0, device=fa.device)
    t0 = time.perf_counter()
    steady_jacobian_elements_autodiff(fa.geom, fa.space, up0, 1.0 / RE).cpu()
    t_jac = time.perf_counter() - t0
    log(f"phase 34: operators at n = {n} ({held / 1e9:.3f} GB on the card before): A nnz "
        f"{a.nnz}, E nnz {e.nnz}, ||A||_F = {np.sqrt((a.data ** 2).sum()):.10e}, B {b.shape}, "
        f"C {c.shape}; get_all(autodiff=False) {t_all:.2f} s on the host, get_A(autodiff=True) "
        f"{t_ad:.2f} s (element Jacobians by torch.func.jacfwd on the card in f64, first call; "
        f"a second call of the Jacobians alone {t_jac:.3f} s; peak "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB); max|A_ad - A_man| / max|A_man| "
        f"= {ad_err:.3e} (tol 1e-10) ({card})")
    if not ad_err <= 1e-10:
        raise AssertionError(f"phase 34: autodiff A differs from manual A by {ad_err:.3e}")
    del a_ad

    # ── phase 35: shift-invert eigenvalues, host and card ────────────────────
    t0 = time.perf_counter()
    vals_h = get_mat_vp_shift_invert(a, e, n=EIG_HOST_N, sigma=SIGMA, return_vectors=False)
    t_host = time.perf_counter() - t0
    ref_err = abs(vals_h[0] - EIG_REF)
    log(f"phase 35: host ARPACK shift-invert (splu) at sigma = {SIGMA}: {t_host:.2f} s; leading "
        f"{vals_h[0]:.12f}, |lambda - JAX's {EIG_REF:.12f}| = {ref_err:.3e} (tol {EIG_REF_TOL}); "
        f"all {np.round(vals_h, 6).tolist()}")
    if not ref_err <= EIG_REF_TOL:
        raise AssertionError(f"phase 35: host eigenvalue {vals_h[0]} is {ref_err:.3e} from JAX's")
    torch.cuda.reset_peak_memory_stats(dev)
    stats = {}
    t0 = time.perf_counter()
    vals_d, _ = eig_arnoldi_dense_device(a, e, n=8, sigma=SIGMA, n_krylov=60, device=dev,
                                         stats=stats)
    t_dev = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    dev_err = abs(vals_d[0] - vals_h[0])
    log(f"phase 35: eig_arnoldi_dense_device (complex64, n_krylov 60) {t_dev:.2f} s: dense "
        f"A - sigma E and its LU {stats['lu_seconds']:.2f} s, Arnoldi loop "
        f"{stats['arnoldi_seconds']:.2f} s; peak device memory {peak / 1e9:.2f} GB (one n x n "
        f"complex64 {8 * n * n / 1e9:.2f} GB); leading {vals_d[0]:.8f}, |lambda_dev - "
        f"lambda_host| = {dev_err:.3e} (tol {EIG_DEV_TOL}); all {np.round(vals_d, 6).tolist()} "
        f"({card})")
    if not dev_err <= EIG_DEV_TOL:
        raise AssertionError(f"phase 35: device eigenvalue {vals_d[0]} is {dev_err:.3e} from "
                             f"the host's {vals_h[0]}")
    if peak > 2 * 8 * n * n + ANALYSIS_SLACK:
        raise AssertionError(f"phase 35: peak device memory {peak / 1e9:.2f} GB")

    # ── phase 36: the frequency response, host and card ──────────────────────
    ww = np.asarray(FREQ_WW)
    t0 = time.perf_counter()
    h_host = get_frequency_response(a, b, c, e, ww)
    t_host = (time.perf_counter() - t0) / len(ww)
    torch.cuda.reset_peak_memory_stats(dev)
    stats = {}
    h_dev = get_frequency_response_device(a, b, c, e, ww, device=dev, stats=stats)
    peak = torch.cuda.max_memory_allocated(dev)
    scale = np.abs(h_host).max()
    err = np.abs(h_dev - h_host).max() / scale
    err0 = np.abs(stats["h_unrefined"] - h_host).max() / scale
    log(f"phase 36: H(jw) at w = {list(FREQ_WW)}, {h_host.shape[1]} x {h_host.shape[2]}: host "
        f"splu {t_host:.2f} s per w; card (complex64, one refinement sweep) "
        f"{[round(t, 2) for t in stats['seconds']]} s per w; peak device memory "
        f"{peak / 1e9:.2f} GB; max|H_dev - H_host| / max|H_host| = {err:.3e} (tol {FREQ_TOL}), "
        f"unrefined {err0:.3e}; max|H_host| = {scale:.6e} ({card})")
    if not err <= FREQ_TOL:
        raise AssertionError(f"phase 36: H differs from the host's by {err:.3e}")
    if peak > 2 * 8 * n * n + ANALYSIS_SLACK:
        raise AssertionError(f"phase 36: peak device memory {peak / 1e9:.2f} GB")
    log(f"phases 34-36: {time.perf_counter() - t_phases:.1f} s wall ({card})")
    return a, e, b, c, h_host


# ── Controller synthesis and the population search (phases 37-39) ────────────

ROM_K = 2  # eigenpairs per ARPACK call of modal_rom: the unstable pair and the next
LQG_GRID = (0.1, 1.0, 10.0)  # examples/synthesize_controller.py's qx
DLQG_DT = 0.005  # the cylinder's dt
SYN_STEPS = 400  # 2 time units, a quarter of a shedding period (2 pi / 0.77)
SYN_TOL = 5e-4  # the reference's f32 pin on y (tests/integration/test_cylinder.py)
#: 3 generations, where 6 would cost ~13 s more: phase 43 needs the time
POP_OPTIONS = {"n_iter": 3, "popsize": BATCH, "sigma0": 0.5, "seed": 0}
LABELS = ("K1", "K2", "P1", "K3", "F", "S", "R")


def captured(st) -> int:
    """The Stepper's programs that hold a captured CUDA graph."""
    return sum(p.graph is not None for p in st._programs.values())


def sampled_radius(rom, k, dt: float, sign: float) -> float:
    """Spectral radius of the ZOH-sampled ROM with the discrete compensator
    ``k`` (its matrices the sampled ones) fed sign * y."""
    from flowcontrol_tpu_torch.utils.statespace import c2d_zoh

    ad, bd, cd, _ = (np.asarray(m) for m in c2d_zoh(rom, dt))
    m = np.block([[ad, bd @ np.asarray(k.C)], [sign * np.asarray(k.B) @ cd, np.asarray(k.A)]])
    return float(np.abs(np.linalg.eigvals(m)).max())


def synthesis(ops: tuple, u0: np.ndarray, p0: np.ndarray, counters, card: str,
              factors: Path) -> None:
    """Phases 37-39: a reduced model and LQG synthesis from phase 34's
    operators (host), the example's three candidates as one B = 3 rollout,
    and the population search: BATCH candidate compensators a generation,
    scored by one closed-loop rollout of the cylinder through K1, K2, P1 and
    S."""
    import flowcontrol_tpu_torch.utils.lticontrol as ltc
    from flowcontrol_tpu_torch.core.controller import Controller, stack_controllers
    from flowcontrol_tpu_torch.examples.synthesize_controller import lqg_population_cost
    from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver
    from flowcontrol_tpu_torch.utils.linalg import modal_rom
    from flowcontrol_tpu_torch.utils.optim_algs import minimize

    a, e, b, c, h_host = ops
    t_phases = time.perf_counter()

    # ── phase 37: the reduced model and the synthesis, on the host ──────────
    t0 = time.perf_counter()
    rom, kept = modal_rom(a, e, b, c, shifts=(SIGMA,), k_per_shift=ROM_K)
    t_rom = time.perf_counter() - t0
    rom_err = abs(kept[0] - EIG_REF)
    h_rom = rom.frequency_response(np.asarray(FREQ_WW))
    log(f"phase 37: modal_rom(k_per_shift={ROM_K}, shifts=({SIGMA},)) {t_rom:.2f} s (two ARPACK "
        f"calls, A and A^T): order {rom.nstates}, {rom.ninputs} inputs, {rom.noutputs} outputs; "
        f"kept {np.round(kept, 8).tolist()}, |kept[0] - EIG_REF| = {rom_err:.3e} (tol "
        f"{EIG_REF_TOL}); poles {np.round(np.linalg.eigvals(rom.A), 8).tolist()}")
    for w, hr, hh in zip(FREQ_WW, h_rom, h_host):
        log(f"phase 37: H(j{w}) ROM {np.round(hr, 6).tolist()} | host (phase 36) "
            f"{np.round(hh, 6).tolist()}; max|H_rom - H_host| / max|H_host| "
            f"{np.abs(hr - hh).max() / np.abs(hh).max():.3e} (printed, not held)")
    if not rom_err <= EIG_REF_TOL:
        raise AssertionError(f"phase 37: the ROM's leading eigenvalue {kept[0]} is {rom_err:.3e} "
                             f"from EIG_REF")
    stable = {1.0: [], -1.0: []}
    for qx in LQG_GRID:
        k, _, _ = ltc.lqg_regulator(rom, qx, 1.0, 1.0, 1.0)
        absc = {sg: float(np.linalg.eigvals(rom.feedback(k, sign=sg).A).real.max())
                for sg in stable}
        for sg, v in absc.items():
            stable[sg].append(v < 0)
        log(f"phase 37: lqg_regulator(rom, qx={qx}, 1, 1, 1): order {k.nstates}; the ROM closed "
            f"loop's spectral abscissa {absc[1.0]:+.6f} (sign +1), {absc[-1.0]:+.6f} (sign -1)")
    kd, _, _ = ltc.dlqg_regulator(rom, DLQG_DT)
    log(f"phase 37: dlqg_regulator(rom, dt={DLQG_DT}): the sampled ROM loop's spectral radius "
        f"{sampled_radius(rom, kd, DLQG_DT, 1.0):.6f} (sign +1), "
        f"{sampled_radius(rom, kd, DLQG_DT, -1.0):.6f} (sign -1)")
    signs = [sg for sg, ok in stable.items() if all(ok)]
    if len(signs) != 1:
        raise AssertionError(f"phase 37: the grid's ROM loops are stable under signs {signs}")
    sign = signs[0]
    log(f"phase 37: feedback sign {sign:+.0f}: the one under which every grid candidate "
        f"stabilizes the ROM (the Stepper feeds u = Cd xk + Dd (sign y)); "
        f"examples/synthesize_controller.py rolls with -1")

    # ── phase 38: the example's three candidates at full width, B = 3 ──────
    fm = CylinderFlowSolver.make_default(Re=RE, num_steps=SYN_STEPS, device="cuda",
                                         stepper_options={"force_substructure": True})
    fm._assign_steady_state(u0, p0)
    fm.initialize_time_stepping()
    t0 = time.perf_counter()
    os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = str(factors)  # phase 6's entry, streamed
    try:
        st = fm.stepper
    finally:
        os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = "off"
    t_factor = time.perf_counter() - t0
    loaded = st._solvers[st._order_idx[2]].loaded_from
    dt = fm.params_time.dt
    up0, y0 = fm._carry.u_n.clone(), np.asarray(fm.y_meas, dtype=float)
    cands = [Controller(k.A, k.B, k.C, k.D)
             for k in (ltc.lqg_regulator(rom, qx, 1.0, 1.0, 1.0)[0] for qx in LQG_GRID)]
    roll = st.closed_loop_fn(SYN_STEPS, sign)
    nc = len(cands)
    args3 = (st.init_carry(up0.expand(nc, -1).contiguous()),
             stack_controllers(cands, dt, dtype=np.float32), np.repeat(y0[None], nc, 0))
    for cnt in counters:
        cnt.launches = 0
    t_b3 = []
    for _ in range(2):  # the first run builds S's plans and captures the graph
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, (ys3, des3, us3, div3) = roll(*args3)
        torch.cuda.synchronize()
        t_b3.append(time.perf_counter() - t0)
        if len(t_b3) == 1:
            launches3, first3 = [cnt.launches for cnt in counters], ys3
    if not (bool(torch.isfinite(ys3).all() and torch.isfinite(des3).all())
            and not bool(div3.any()) and torch.equal(first3, ys3)):
        raise AssertionError("phase 38: a B = 3 member is not finite, or the two runs differ")
    errs = []
    for i, k in enumerate(cands):
        k.reset()
        fm._carry = st.init_carry(up0)
        y, ys1 = y0, []
        for _ in range(SYN_STEPS):
            y = fm.step(k.step(sign * y, dt))
            ys1.append(y)
        errs.append(rel_err(ys3[:, i].double().cpu(), torch.as_tensor(np.asarray(ys1)))[0])
    _, open_out = st.rollout_open_loop(st.init_carry(up0), np.zeros((SYN_STEPS, st.n_act)))
    de_open = float(open_out.dE[-1])
    log(f"phase 38: multifrontal Stepper (force_substructure) built in {t_factor:.2f} s (its "
        f"factor loaded_from {loaded!r}: phase 6's cache entry); "
        f"{nc} LQG candidates (qx {list(LQG_GRID)}, sign {sign:+.0f}) as one B = {nc} rollout of "
        f"{SYN_STEPS} steps in {t_b3[0]:.2f} s (S's plans and the capture included) and "
        f"{t_b3[1]:.2f} s again, bitwise equal ({nc * SYN_STEPS / t_b3[1]:.1f} aggregate "
        f"steps/s); launches of the first {dict(zip(LABELS, launches3))}; terminal "
        f"dE {des3[-1].double().cpu().numpy().tolist()}, open loop {de_open:.6e}; members "
        f"against their fs.step + Controller.step loops, y max|b-s|/max|s| "
        f"{[f'{v:.3e}' for v in errs]} (tol {SYN_TOL:g})")
    if launches3[4] == 0 or launches3[1] or launches3[2]:
        raise AssertionError(f"phase 38: B = {nc} launches {launches3}: F expected, K2/P1 not")
    if loaded != "stream":
        raise AssertionError(f"phase 38: the factor came from {loaded!r}, not phase 6's entry")
    if not max(errs) <= SYN_TOL:
        raise AssertionError(f"phase 38: members against their single streams: {errs}")

    # ── phase 39: the population search, BATCH candidates a generation ──────
    carry_b = st.init_carry(up0.expand(BATCH, -1).contiguous())
    y0_b = np.repeat(y0[None], BATCH, 0)
    gens: list[dict] = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed_roll(carry, k_mats, yk):
        g = gens[-1]
        g["host_s"] = time.perf_counter() - g["t0"]  # synthesis, ZOH, stacking
        torch.cuda._sleep(200_000_000)  # ~100 ms: the host enqueues the rollout ahead of it
        for cnt in counters:
            cnt.launches = 0
        start.record()
        out = roll(carry, k_mats, yk)
        end.record()
        torch.cuda.synchronize()
        g["launches"] = [cnt.launches for cnt in counters]
        g["device_s"] = start.elapsed_time(end) / 1e3
        g["captured"] = captured(st)
        return out

    cost_b = lqg_population_cost(timed_roll, carry_b, y0_b, rom, dt)

    def batch_cost(thetas):
        gens.append({"t0": time.perf_counter(), "thetas": np.array(thetas)})
        costs = cost_b(thetas)
        gens[-1].update(costs=costs, wall_s=time.perf_counter() - gens[-1]["t0"])
        return costs

    captured0 = captured(st)
    t0 = time.perf_counter()
    res = minimize(None, np.zeros(4), "pop", POP_OPTIONS, verbose=False, batch_costfun=batch_cost)
    t_search = time.perf_counter() - t0
    steps = BATCH * SYN_STEPS
    for i, g in enumerate(gens):
        n_inf = int(np.isinf(g["costs"]).sum())
        log(f"phase 39: generation {i + 1}: host {g['host_s']:.3f} s (lqg_regulator x {BATCH}, "
            f"ZOH, stacking), device {g['device_s']:.3f} s (queued CUDA events: {steps / g['device_s']:.1f} "
            f"aggregate steps/s), wall {g['wall_s']:.3f} s; best cost "
            f"{np.min(g['costs']):.6e}, +inf {n_inf}/{BATCH}; captured graphs {g['captured']}; "
            f"launches {dict(zip(LABELS, g['launches']))} ({g['launches'][1] / SYN_STEPS:.2f} K2 and "
            f"{g['launches'][2] / SYN_STEPS:.2f} P1 a step, the borrowed first step included)")
        if n_inf > BATCH // 2:
            raise AssertionError(f"phase 39: generation {i + 1}: {n_inf} candidates score +inf")
    if captured(st) != captured0 + 1 or any(g["captured"] != captured0 + 1 for g in gens):
        raise AssertionError(f"phase 39: captured graphs {captured0} before, "
                             f"{[g['captured'] for g in gens]} after each generation")
    device_s = sum(g["device_s"] for g in gens)
    log(f"phase 39: search {len(gens)} generations x {BATCH} in {t_search:.2f} s wall: "
        f"{len(gens) * steps / t_search:.1f} aggregate steps/s end to end, "
        f"{len(gens) * steps / device_s:.1f} on the device (PR 9's B = {BATCH} closed-loop graph: "
        f"29,396-29,556); host share of the wall "
        f"{sum(g['host_s'] for g in gens) / t_search:.3f}; res.x {res.x.tolist()}, res.fun "
        f"{res.fun:.6e}, nfev {res.nfev} ({card})")
    inf_thetas = [th for g in gens for th, cost in zip(g["thetas"], g["costs"]) if np.isinf(cost)]
    failed = 0
    for th in inf_thetas:
        try:
            ltc.lqg_regulator(rom, *(10.0 ** th))
        except (np.linalg.LinAlgError, ValueError):
            failed += 1
    log(f"phase 39: {len(inf_thetas)} candidates scored +inf: {failed} failed the Riccati "
        f"solve, {len(inf_thetas) - failed} diverged in the rollout")
    rerun = batch_cost(gens[0]["thetas"])
    if not np.array_equal(rerun, gens[0]["costs"]):
        raise AssertionError("phase 39: generation 1 re-run does not give the same costs")
    # res.x, theta0 and the open loop, each a single stream (B = 1) through F
    carry_1, y0_1 = st.init_carry(up0[None]), y0[None]
    for cnt in counters:
        cnt.launches = 0
    cost_1 = lqg_population_cost(roll, carry_1, y0_1, rom, dt)
    best_1 = float(cost_1(res.x[None])[0])
    launches1 = [cnt.launches for cnt in counters]
    theta0_1 = float(cost_1(np.zeros((1, 4)))[0])
    n = rom.nstates
    zero = tuple(np.zeros((1,) + s, dtype=np.float32)
                 for s in ((n, n), (n, rom.noutputs), (rom.ninputs, n), (rom.ninputs, rom.noutputs)))
    _, (ys_o, _, _, _) = roll(carry_1, zero, y0_1)
    open_1 = float((ys_o.double() ** 2).sum() * dt)
    rel = abs(best_1 - res.fun) / abs(res.fun)
    log(f"phase 39: generation 1 re-run bitwise equal; res.x single stream (B = 1, launches "
        f"{dict(zip(LABELS, launches1))}) cost {best_1:.6e} against its batched {res.fun:.6e}: "
        f"relative {rel:.3e} (tol {SYN_TOL:g}); theta0 {theta0_1:.6e}, open loop {open_1:.6e} "
        f"over the same {SYN_STEPS} steps")
    if launches1[4] == 0 or launches1[1] or launches1[2]:
        raise AssertionError(f"phase 39: B = 1 launches {launches1}: F expected, K2/P1 not")
    if not rel <= SYN_TOL:
        raise AssertionError(f"phase 39: res.x's single-stream cost is {rel:.3e} from its batched")
    log(f"phases 37-39: {time.perf_counter() - t_phases:.1f} s wall ({card})")


# ── Multi-GPU through torch.distributed (phase 43) ──────────────────────────

SHARD_RANKS = 4  # gloo ranks sharing the one card
SHARD_STEPS = 10  # each sharded leg's steps (phase 3's controls on the single stream)
SHARD_GMRES_STEPS = 2
#: the sharded GMRES leg's stepper_options: a cycle of 10 restarts of 10
#: Arnoldi steps (phase 41's 30 x 30 converge as well, at 9x the
#: collectives); the leg steps BDF2 from its first step (start_order 2: one
#: system and one SIMPLE build)
SHARD_GMRES_OPTIONS = {"krylov_rtol": 1e-8, "gmres_iters": 10}
#: a sharded run against its single-rank run on the same card (f32, other
#: summation orders: the sharded sums and the per-stage sweep against F):
#: the field and y relative to their peaks
SHARD_TOL = 1e-4
SHARD_PIN = 1e-4  # the reference's f32 pin: the 10-step field error against host f64
#: the sharded ω sweep's reduced width: the reference's coarse cylinder mesh
#: (its dense complex systems fit four ranks on one card; at 56,383 dofs one
#: is 25.4 GB), at these ω
OMEGA_MESH = dict(yinf=5.0, xinf=15.0, xinfa=-5.0, n1=4.0, n2=2.0, n3=0.8, segments=80)
OMEGA_WW = (0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 1.75)
OMEGA_TOL = 2e-4  # phase 36's
SHARD_INIT_TIMEOUT = 60  # seconds a collective (and the rendezvous) may wait
SHARD_WORLD_TIMEOUT = 600  # seconds a world may take before it is stopped


def shard_counters() -> tuple:
    """The counters phase 43's ranks read: K1, K2, P1, F, S (csr_matmul), R
    (csr_residual)."""
    from flowcontrol_tpu_torch.ops.mf_fused import multifrontal_solve_fused
    from flowcontrol_tpu_torch.ops.mf_matvec import stack_matvec, sweep_gather
    from flowcontrol_tpu_torch.ops.nl import nonlinear_convection
    from flowcontrol_tpu_torch.ops.spmm import csr_matmul, csr_residual

    return (nonlinear_convection, stack_matvec, sweep_gather, multifrontal_solve_fused,
            csr_matmul, csr_residual)


def batch_carry(c1: dict, rows: int, device, dtype):
    """Phase 43's batched rollouts start from the single rank's carry after
    its first step (``it`` = 1, past the borrowed BDF1 step), every member
    the same: ``c1`` broadcast to ``rows`` members."""
    from flowcontrol_tpu_torch.core.stepper import carry_from_numpy

    d = {k: np.broadcast_to(v, (rows,) + np.shape(v)) for k, v in c1.items() if k != "it"}
    return carry_from_numpy(dict(d, it=c1["it"]), device, dtype)


def batch_controls(rows: slice) -> np.ndarray:
    """Phase 43's batched open loop: member b takes gains[b] x phase 3's
    controls at every step, (SHARD_STEPS, len(rows), 2)."""
    gains = np.linspace(0.5, 1.5, BATCH)[rows]
    return np.broadcast_to(gains[None, :, None] * np.asarray([0.3, -0.2]),
                           (SHARD_STEPS, len(gains), 2)).copy()


def shard_rank(rank: int, size: int, spec: dict) -> dict:
    """One rank of phase 43 (a process of ``run_world``): the cylinder from
    the parent's files (mesh, base flow) and factor cache entry (streamed),
    then the legs of ``spec['legs']``, each with its launches counted from
    0: 'space' (every rank one 'space' group: ``shard_stepper``, SHARD_STEPS
    ``fs.step`` calls, 10 more at zero control for the field error, and
    ``DofShardedOperator`` on the mass), 'batch' ({batch 2, space 2}: the
    B = BATCH open loop and the fused closed loop from the single rank's
    carry after its first step, this rank's half of the batch), 'gmres' (the
    GMRES backend sharded, SHARD_GMRES_STEPS BDF2 steps) and
    'omega' (the sharded frequency sweep on ``spec['omega']``'s system).
    Returns this rank's numbers; the parent prints and checks them."""
    import torch.distributed as dist

    from flowcontrol_tpu_torch.core.stepper import carry_to_numpy
    from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver
    from flowcontrol_tpu_torch.parallel import comm
    from flowcontrol_tpu_torch.parallel.dofsharding import DofShardedOperator
    from flowcontrol_tpu_torch.parallel.sharding import make_device_mesh, shard_stepper
    from flowcontrol_tpu_torch.utils.linalg import get_frequency_response_mpi

    os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = spec["cache"]
    dev = torch.device("cuda", torch.cuda.current_device())
    counters = shard_counters()
    backend = str(dist.get_backend())
    out = {"rank": rank, "backend": backend, "device": str(dev)}
    t0 = time.perf_counter()
    fs = CylinderFlowSolver.make_default(
        Re=RE, num_steps=2 * SHARD_STEPS, device=dev, meshpath=spec["meshpath"],
        path_out=Path(tempfile.mkdtemp(prefix=f"shard_rank{rank}_", dir=spec["out"])),
        stepper_options={"force_substructure": True})
    fs.load_steady_state(spec["steady"])
    out["t_make"] = time.perf_counter() - t0

    def stepper(order=None):
        fs._stepper = fs._carry = fs._step_compiled = None
        fs.initialize_time_stepping()
        if order is not None:
            fs.order = order
        t0 = time.perf_counter()
        st = fs.stepper  # the systems (the factor streamed from the parent's entry), init_carry
        torch.cuda.synchronize(dev)
        return st, time.perf_counter() - t0

    def zero():
        for c in counters:
            c.launches = 0

    def read():
        return [c.launches for c in counters]

    if "space" in spec["legs"]:
        st, t_st = stepper()
        oi = st._order_idx[2]
        mf = st._solvers[oi]
        loaded, whole = mf.loaded_from, mf.factor_bytes
        del mf
        gc.collect()
        mem_before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        mesh = make_device_mesh()
        shard_stepper(st, mesh.space)
        gc.collect()
        torch.cuda.synchronize(dev)
        t_shard = time.perf_counter() - t0
        mem_after = torch.cuda.memory_allocated(dev)
        smf = st._sharded_solvers[oi]
        zero()
        ys, t_loop = [], None
        for i in range(SHARD_STEPS):
            if i == 1:  # past the borrowed BDF1 step
                torch.cuda.synchronize(dev)
                t_loop = time.perf_counter()
            ys.append(fs.step(controls(i)))
        torch.cuda.synchronize(dev)
        sps = (SHARD_STEPS - 1) / (time.perf_counter() - t_loop)
        launches = read()
        carry10 = carry_to_numpy(fs._carry)
        carry, _ = st.rollout_open_loop(fs._carry, np.zeros((10, st.n_act)))
        x20 = carry.u_n.double().cpu().numpy()
        out["space"] = dict(
            staging=comm.staging(mesh.space, dev), t_stepper=t_st, loaded_from=loaded,
            t_shard=t_shard, whole_factor_bytes=whole, kinds=list(st._solver_kinds),
            per_device_factor_bytes=smf.per_device_factor_bytes,
            total_factor_bytes=smf.total_factor_bytes,
            per_device_index_bytes=smf.per_device_index_bytes, held=smf.factor_bytes,
            modes=[s["mode"] for s in smf._stages], gathers=smf.gathers_per_solve,
            per_solve=smf.launches_per_solve(),
            solves=(1 + st.BORROW_ITERS) + (SHARD_STEPS - 1) * (1 + st._refine.get(oi, 0)),
            mem_before=mem_before, mem_after=mem_after, sps=sps, launches=launches,
            ys=np.asarray(ys), carry10={k: carry10[k] for k in ("u_n", "u_nn")}, x20=x20,
            x10=carry10["u_n"])
        # the dof-sharded operator on the mass, f64, at the full width
        op = DofShardedOperator(fs.forms.mass_elements(), fs.space.cell_dofs, fs.space,
                                mesh.space, dev, torch.float64)
        x = np.random.default_rng(5).standard_normal(fs.space.n_dofs)
        xs = op.shard_vector(x)
        y = op.apply(xs)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(10):
            y = op.apply(xs)
        torch.cuda.synchronize(dev)
        out["dof"] = dict(ms=(time.perf_counter() - t0) * 100.0, y=op.unshard_vector(y),
                          nbytes=op.per_device_nbytes(), n_loc=op.part.n_loc,
                          cells=op.n_cells)
        del st, smf, carry, op
        gc.collect()
        torch.cuda.empty_cache()

    if "batch" in spec["legs"]:
        st, t_st = stepper()
        mesh2 = make_device_mesh(n_batch=2)
        shard_stepper(st, mesh2.space, mesh2.batch)
        half = BATCH // 2
        rows = slice(mesh2.batch_rank * half, (mesh2.batch_rank + 1) * half)
        carry = batch_carry(spec["carry1"], half, dev, st.dtype)
        zero()
        t0 = time.perf_counter()
        _, outs = st.make_rollout_open_loop()(carry, batch_controls(rows))
        torch.cuda.synchronize(dev)
        t_open, l_open = time.perf_counter() - t0, read()
        k_mats = tuple(m[rows] for m in controller_population(st, fs.params_time.dt)[2])
        zero()
        t0 = time.perf_counter()
        _, (y_cl, de_cl, u_cl, _) = st.closed_loop_fn(SHARD_STEPS)(
            carry, k_mats, np.zeros((half, st.ns)))
        torch.cuda.synchronize(dev)
        t_closed, l_closed = time.perf_counter() - t0, read()
        ((oi, smf),) = st._sharded_solvers.items()
        out["batch"] = dict(
            per_solve=smf.launches_per_solve(),
            solves=SHARD_STEPS * (1 + st._refine.get(oi, 0)),  # from it = 1: BDF2 throughout
            rows=(rows.start, rows.stop), space_rank=mesh2.space_rank, t_stepper=t_st,
            staging=comm.staging(mesh2.space, dev), y_open=outs.y.double().cpu().numpy(),
            y_closed=y_cl.double().cpu().numpy(), u_closed=u_cl.double().cpu().numpy(),
            t_open=t_open, t_closed=t_closed, launches_open=l_open, launches_closed=l_closed,
            per_device_factor_bytes=smf.per_device_factor_bytes,
            total_factor_bytes=smf.total_factor_bytes)
        del st, smf, carry, outs
        gc.collect()
        torch.cuda.empty_cache()

    if "gmres" in spec["legs"]:
        fs.params_solver.solver_backend = "gmres"
        fs.params_solver.stepper_options = dict(SHARD_GMRES_OPTIONS)
        st, t_st = stepper(order=2)
        shard_stepper(st, make_device_mesh().space)
        zero()
        t0 = time.perf_counter()
        ys, res = [], []
        for i in range(SHARD_GMRES_STEPS):
            ys.append(fs.step(controls(i)))
            res.append(fs.last_solve_res)
        torch.cuda.synchronize(dev)
        out["gmres"] = dict(t_stepper=t_st, t_steps=time.perf_counter() - t0, ys=np.asarray(ys),
                            res=res, cycles=st.krylov_cycles, launches=read(),
                            x=np.asarray(fs.fields.up_))
        del st
        gc.collect()
        torch.cuda.empty_cache()

    if "omega" in spec["legs"]:
        a, e, b, c = spec["omega"]
        t0 = time.perf_counter()
        h = get_frequency_response_mpi(a, b, c, e, np.asarray(OMEGA_WW), dist.group.WORLD,
                                       device=dev)
        out["omega"] = dict(h=h, seconds=time.perf_counter() - t0)
    return out


def omega_system() -> tuple:
    """A, E, B, C of the cylinder on the coarse mesh (OMEGA_MESH), around its
    host Picard + Newton base flow: the sharded ω sweep's reduced system."""
    from flowcontrol_tpu_torch.core.operatorgetter import OperatorGetter
    from flowcontrol_tpu_torch.mesh.generation import cylinder_mesh
    from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver

    fo = CylinderFlowSolver.make_default(Re=RE, device="cuda", mesh=cylinder_mesh(**OMEGA_MESH))
    fo.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=3)
    fo.compute_steady_state(u_ctrl=[0.0, 0.0], method="newton", initial_guess=fo.fields.UP0,
                            max_iter=10)
    og = OperatorGetter(fo)
    return og.get_A(autodiff=False), og.get_mass_matrix(), og.get_B(), og.get_C()


def sharded_phase(u0: np.ndarray, p0: np.ndarray, host, card: str, factors: Path) -> dict:
    """Phase 43: the multi-GPU layer (``flowcontrol_tpu_torch/parallel``) on
    the card, at the default cylinder's 56,383 dofs (``force_substructure``,
    f32 with the refinement sweep), in a temporary directory: the parent
    writes the mesh and phase 3's base flow through the port's files,
    streams its factor from a factor cache of the phase's own (a copy of
    ``factors``, phase 6's entry: phase 42 measures the cold build) and runs the
    single-rank references (SHARD_STEPS ``fs.step`` calls;
    the B = BATCH open loop and the fused closed loop; SHARD_GMRES_STEPS
    GMRES steps; the host's H(jω) on the reduced system); then a world of
    SHARD_RANKS gloo ranks on this card runs the legs of :func:`shard_rank`
    (each rank streams the factor) and a world of 1 over NCCL the 'space'
    leg. Returns the ranks' launches for the kernels line: {'B1': [K1, K2,
    P1], 'batch': [K1, K2, P1, S, R]} summed over the ranks."""
    from flowcontrol_tpu_torch.core.stepper import carry_to_numpy
    from flowcontrol_tpu_torch.fem.assembly import to_scipy_csr
    from flowcontrol_tpu_torch.mesh.io import write_field_snapshot, write_xdmf_mesh
    from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver, default_cylinder_mesh
    from flowcontrol_tpu_torch.parallel.launch import run_world
    from flowcontrol_tpu_torch.solvers import factor_cache
    from flowcontrol_tpu_torch.utils.linalg import get_frequency_response

    t_phase = time.perf_counter()
    saved_cache = os.environ.get("FLOWCONTROL_TPU_FACTOR_CACHE")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard_") as tmp:
        out = Path(tmp)
        (out / "ranks").mkdir()
        # a copy of phase 6's entry, which the parent and the ranks stream
        cache = out / "factors"
        shutil.copytree(factors, cache)
        os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = str(cache)
        try:
            meshpath = out / "mesh" / "cylinder.xdmf"
            write_xdmf_mesh(meshpath, default_cylinder_mesh())
            fs = CylinderFlowSolver.make_default(
                Re=RE, num_steps=2 * SHARD_STEPS, device="cuda", meshpath=meshpath,
                path_out=out / "single", stepper_options={"force_substructure": True})
            write_field_snapshot(fs.paths.U0, "U0", u0, 0.0, append=False)
            write_field_snapshot(fs.paths.P0, "P0", p0, 0.0, append=False)
            fs.load_steady_state()
            fs.initialize_time_stepping()
            t0 = time.perf_counter()
            st = fs.stepper  # streamed from the copy of phase 6's entry
            factor_cache.flush()
            t_factor = time.perf_counter() - t0
            whole = st._solvers[st._order_idx[2]].factor_bytes
            loaded = st._solvers[st._order_idx[2]].loaded_from
            m_csr = to_scipy_csr(fs.forms.mass_elements(), fs.space.cell_dofs, fs.space.n_dofs)
            ys_ref, carry1 = [], None
            for i in range(SHARD_STEPS):
                ys_ref.append(fs.step(controls(i)))
                if i == 0:
                    carry1 = carry_to_numpy(fs._carry)
            ys_ref = np.asarray(ys_ref)
            x10_ref = fs._carry.u_n.double().cpu().numpy()
            batch = batch_carry(carry1, BATCH, st.device, st.dtype)
            _, outs = st.make_rollout_open_loop()(batch, batch_controls(slice(None)))
            y_open_ref = outs.y.double().cpu().numpy()
            k_mats = controller_population(st, fs.params_time.dt)[2]
            _, (y_cl_ref, _, _, _) = st.closed_loop_fn(SHARD_STEPS)(
                batch, k_mats, np.zeros((BATCH, st.ns)))
            y_closed_ref = y_cl_ref.double().cpu().numpy()
            del st, batch, outs, y_cl_ref
            fs.params_solver.solver_backend = "gmres"
            fs.params_solver.stepper_options = dict(SHARD_GMRES_OPTIONS)
            fs._stepper = fs._carry = fs._step_compiled = None
            fs.initialize_time_stepping()
            fs.order = 2  # the GMRES legs: BDF2 from the first step (one system)
            ys_g_ref = np.asarray([fs.step(controls(i)) for i in range(SHARD_GMRES_STEPS)])
            x_g_ref = np.asarray(fs.fields.up_)
            res_g_ref = fs.last_solve_res
            fs._stepper = fs._carry = fs._step_compiled = None
            t0 = time.perf_counter()
            a, e, b, c = omega_system()
            h_ref = get_frequency_response(a, b, c, e, np.asarray(OMEGA_WW))
            t_omega = time.perf_counter() - t0
            n_omega = a.shape[0]
            spec = dict(cache=str(cache), meshpath=str(meshpath), out=str(out / "ranks"),
                        steady=[str(fs.paths.U0), str(fs.paths.P0)], carry1=carry1,
                        legs=("space", "batch", "gmres", "omega"), omega=(a, e, b, c))
            free_card()
            if loaded != "stream":
                raise AssertionError(f"phase 43: the parent's factor came from {loaded!r}, "
                                     f"not phase 6's entry")
            log(f"phase 43: set-up in the parent: the mesh and phase 3's base flow through the "
                f"port's files, its factor streamed from a copy of phase 6's entry, {cache} "
                f"(loaded_from "
                f"{loaded!r}, "
                f"{t_factor:.2f} s, {whole / 1e9:.4f} GB of stacks), the single-rank "
                f"references: {SHARD_STEPS} "
                f"fs.step calls, B={BATCH} open and closed loops of {SHARD_STEPS} steps, "
                f"{SHARD_GMRES_STEPS} GMRES steps (res {res_g_ref:.2e}), and the coarse "
                f"cylinder's A, E, B, C ({n_omega} dofs: the reduced ω sweep) with its host "
                f"H(jw) ({t_omega:.2f} s); {time.perf_counter() - t_phase:.1f} s")
            t0 = time.perf_counter()
            res4 = run_world(shard_rank, SHARD_RANKS, (spec,), backend="gloo",
                             timeout_s=SHARD_WORLD_TIMEOUT, init_timeout_s=SHARD_INIT_TIMEOUT,
                             threads=2)
            t4 = time.perf_counter() - t0
            t0 = time.perf_counter()
            (res1,) = run_world(shard_rank, 1, (dict(spec, legs=("space",)),), backend="nccl",
                                timeout_s=SHARD_WORLD_TIMEOUT,
                                init_timeout_s=SHARD_INIT_TIMEOUT, threads=4)
            t1 = time.perf_counter() - t0
        finally:
            if saved_cache is None:
                os.environ.pop("FLOWCONTROL_TPU_FACTOR_CACHE", None)
            else:
                os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = saved_cache

    def rel(a_, b_):
        return float(np.linalg.norm(np.asarray(a_) - b_) / np.linalg.norm(b_))

    def peak_rel(a_, b_):
        return float(np.abs(np.asarray(a_) - b_).max() / np.abs(b_).max())

    totals = {"B1": [0, 0, 0], "batch": [0, 0, 0, 0, 0]}
    # ── the all-space legs: 4 gloo ranks on this card, 1 NCCL rank ───────────
    for tag, world in ((f"gloo x{SHARD_RANKS}", res4), ("nccl x1", [res1])):
        s0 = world[0]["space"]
        t0 = time.perf_counter()
        pin = rel(s0["x20"], host.run(10, s0["carry10"]["u_n"], s0["carry10"]["u_nn"]))
        same = all(np.array_equal(r["space"]["x20"], s0["x20"]) for r in world)
        log(f"phase 43 ({tag}): 10-step field error against host f64 {pin:.3e} (tol "
            f"{SHARD_PIN:g}; {time.perf_counter() - t0:.1f} s), every rank's state bitwise "
            f"rank 0's: {same}")
        if not (pin <= SHARD_PIN and same):
            raise AssertionError(f"phase 43 ({tag}): pin {pin}, ranks equal {same}")
        for r in world:
            s = r["space"]
            field = rel(s["x10"], x10_ref)
            y_err = peak_rel(s["ys"], ys_ref)
            k1, k2, p1, f, sm, rr = s["launches"]
            dropped = s["mem_before"] - s["mem_after"]
            log(f"phase 43 ({tag}, rank {r['rank']}, {r['backend']} on {r['device']}, staging "
                f"{s['staging']}): kinds {s['kinds']}, factor streamed ({s['loaded_from']}), "
                f"Stepper {s['t_stepper']:.2f} s, shard_stepper {s['t_shard']:.2f} s; stages "
                f"{s['modes'].count('node')} node / {s['modes'].count('row')} row mode, "
                f"{s['gathers']} all_gathers a solve; factor bytes per rank "
                f"{s['per_device_factor_bytes']} x {len(world)} = {s['total_factor_bytes']} "
                f"(the whole factor {s['whole_factor_bytes']}), index bytes "
                f"{s['per_device_index_bytes']}; memory_allocated {s['mem_before'] / 1e9:.4f} -> "
                f"{s['mem_after'] / 1e9:.4f} GB (dropped {dropped / 1e9:.4f})")
            log(f"phase 43 ({tag}, rank {r['rank']}): {SHARD_STEPS} fs.step calls: "
                f"{s['sps']:.2f} steps/s over the last {SHARD_STEPS - 1} ({r['backend']}, "
                f"{card}); field against the single rank {field:.3e}, y {y_err:.3e} (tol "
                f"{SHARD_TOL:g}); launches K1/K2/P1/F/S/R {s['launches']} (K2/P1 a solve "
                f"{s['per_solve']}, {s['solves']} solves)")
            if not (field <= SHARD_TOL and y_err <= SHARD_TOL):
                raise AssertionError(f"phase 43 ({tag}): field {field}, y {y_err}")
            if (s["per_device_factor_bytes"] * len(world) != s["total_factor_bytes"]
                    or s["held"] != s["per_device_factor_bytes"]
                    or s["kinds"] != ["borrowed", "multifrontal"]
                    or s["loaded_from"] != "stream"):
                raise AssertionError(f"phase 43 ({tag}): the sharded factor {s}")
            if len(world) > 1 and dropped < 0.5 * s["whole_factor_bytes"]:
                raise AssertionError(f"phase 43 ({tag}): only {dropped} bytes dropped")
            want = [SHARD_STEPS, s["solves"] * s["per_solve"][0],
                    s["solves"] * s["per_solve"][1], 0]
            if [k1, k2, p1, f] != want or min(k2, p1) <= 0:
                raise AssertionError(f"phase 43 ({tag}): launches K1/K2/P1/F {[k1, k2, p1, f]}, "
                                     f"expected {want} ({s['solves']} solves of "
                                     f"{s['per_solve']} K2/P1 launches)")
            for i, v in enumerate((k1, k2, p1)):
                totals["B1"][i] += v
    # the dof-sharded operator: every rank gathers the same product
    x = np.random.default_rng(5).standard_normal(m_csr.shape[0])
    want = m_csr @ x
    for r in res4 + [res1]:
        d = r["dof"]
        err = float(np.abs(d["y"] - want).max() / np.abs(want).max())
        log(f"phase 43 (rank {r['rank']} of {r['backend']}): DofShardedOperator on the mass (f64) "
            f"at {m_csr.shape[0]} dofs: n_loc {d['n_loc']}, {d['cells']} cells, "
            f"{d['nbytes'] / 1e6:.2f} MB of CSR, {d['ms']:.3f} ms an apply (halo exchange "
            f"included); against the CSR {err:.3e} (tol 1e-12)")
        if not err <= 1e-12:
            raise AssertionError(f"phase 43: DofShardedOperator {err}")
    # ── {batch 2, space 2}: the B = BATCH open and closed loops ─────────────
    legs = sorted((r["batch"] for r in res4 if r["batch"]["space_rank"] == 0),
                  key=lambda leg: leg["rows"])
    y_open = np.concatenate([leg["y_open"] for leg in legs], axis=1)
    y_closed = np.concatenate([leg["y_closed"] for leg in legs], axis=1)
    e_open, e_closed = peak_rel(y_open, y_open_ref), peak_rel(y_closed, y_closed_ref)
    for r in res4:
        leg = r["batch"]
        log(f"phase 43 ({{batch: 2, space: 2}}, rank {r['rank']}: rows {leg['rows']}, staging "
            f"{leg['staging']}): factor bytes per rank {leg['per_device_factor_bytes']} x 2 = "
            f"{leg['total_factor_bytes']}; open loop {SHARD_STEPS} steps in {leg['t_open']:.2f} "
            f"s ({SHARD_STEPS * BATCH / 2 / leg['t_open']:.1f} steps/s of its rows), launches "
            f"K1/K2/P1/F/S/R {leg['launches_open']}; closed loop in {leg['t_closed']:.2f} s, "
            f"launches {leg['launches_closed']} (K2/P1 a solve {leg['per_solve']}, "
            f"{leg['solves']} solves)")
        want = [SHARD_STEPS, leg["solves"] * leg["per_solve"][0],
                leg["solves"] * leg["per_solve"][1], 0]
        for lst in (leg["launches_open"], leg["launches_closed"]):
            if lst[:4] != want or min(want[1:3]) <= 0:
                raise AssertionError(f"phase 43: batch leg launches K1/K2/P1/F {lst[:4]}, "
                                     f"expected {want}")
        for lst in (leg["launches_open"], leg["launches_closed"]):
            for i, k in enumerate((0, 1, 2, 4, 5)):
                totals["batch"][i] += lst[k]
    log(f"phase 43 ({{batch: 2, space: 2}}): B={BATCH} y against the unsharded rollouts (peak "
        f"relative): open loop {e_open:.3e}, fused closed loop {e_closed:.3e} (tol "
        f"{SHARD_TOL:g})")
    if not (e_open <= SHARD_TOL and e_closed <= SHARD_TOL):
        raise AssertionError(f"phase 43: batch legs {e_open}, {e_closed}")
    # ── GMRES, the ω sweep ───────────────────────────────────────────────────
    for r in res4:
        g = r["gmres"]
        err = rel(g["x"], x_g_ref)
        y_err = peak_rel(g["ys"], ys_g_ref)
        log(f"phase 43 (GMRES, rank {r['rank']}): Stepper {g['t_stepper']:.2f} s; "
            f"{SHARD_GMRES_STEPS} sharded steps in {g['t_steps']:.2f} s, {g['cycles']} cycles, "
            f"res {[f'{v:.2e}' for v in g['res']]}; field against the single rank {err:.3e}, y "
            f"{y_err:.3e} (tol {SHARD_TOL:g}); launches K1/K2/P1/F/S/R {g['launches']}")
        if not (err <= SHARD_TOL and y_err <= SHARD_TOL):
            raise AssertionError(f"phase 43: GMRES {err}, {y_err}")
        if g["launches"] != [SHARD_GMRES_STEPS, 0, 0, 0, 0, 0]:  # K1 a step; SpMVs otherwise
            raise AssertionError(f"phase 43: GMRES launches {g['launches']}")
        totals["B1"][0] += g["launches"][0]
    scale = np.abs(h_ref).max()
    for r in res4:
        o = r["omega"]
        err = float(np.abs(o["h"] - h_ref).max() / scale)
        log(f"phase 43 (omega, rank {r['rank']}): H(jw) at {len(OMEGA_WW)} w over "
            f"{SHARD_RANKS} ranks (reduced: the coarse cylinder, {n_omega} dofs) in "
            f"{o['seconds']:.2f} s; against the host splu {err:.3e} (tol {OMEGA_TOL:g})")
        if not err <= OMEGA_TOL:
            raise AssertionError(f"phase 43: H {err}")
    log(f"phase 43: gloo world of {SHARD_RANKS} {t4:.1f} s, NCCL world of 1 {t1:.1f} s; the "
        f"phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return totals


# ── Checkpoints and the restart (phase 40) ──────────────────────────────────

RESTART_STEPS = 40  # the continuous run
RESTART_SAVE = 20  # a checkpoint every RESTART_SAVE steps; the restart at the first
RESTART_TOL = 1e-5  # restarted y against the continuous run's tail, relative to its peak


def restart_phase(u0: np.ndarray, p0: np.ndarray, counters, card: str, factors: Path) -> dict:
    """Phase 40: the default cylinder's mesh written and read back, phase 3's
    base flow through the steady-state files, a closed loop of RESTART_STEPS
    steps with a checkpoint every RESTART_SAVE, and a second solver
    restarted from the sidecar at BDF2 (multifrontal, K1 and F), in a
    temporary directory, with h5py unimportable throughout; then phase 42
    on that restart (:func:`cache_phase`, whose result it returns)."""
    import dataclasses
    import importlib.util
    import tempfile
    import xml.etree.ElementTree as ET
    from pathlib import Path

    from flowcontrol_tpu_torch.core.controller import Controller
    from flowcontrol_tpu_torch.core.exporter import FlowExporter
    from flowcontrol_tpu_torch.mesh.io import (
        read_data_item,
        read_field_snapshot,
        write_field_snapshot,
        write_xdmf_mesh,
    )
    from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver, default_cylinder_mesh

    t_phase = time.perf_counter()
    h5py_installed = importlib.util.find_spec("h5py") is not None
    saved = sys.modules.get("h5py")
    sys.modules["h5py"] = None  # an import of h5py raises for the whole phase
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_restart_") as tmp:
            out = Path(tmp)
            opts = dict(Re=RE, device="cuda", stepper_options={"force_substructure": True},
                        path_out=out, meshpath=out / "mesh" / "cylinder.xdmf")
            # 1. mesh I/O
            mesh = default_cylinder_mesh()
            t0 = time.perf_counter()
            write_xdmf_mesh(opts["meshpath"], mesh)
            t_write_mesh = time.perf_counter() - t0
            mesh_bytes = sum(f.stat().st_size for f in (out / "mesh").iterdir())
            t0 = time.perf_counter()
            fs = CylinderFlowSolver.make_default(num_steps=RESTART_STEPS,
                                                 save_every=RESTART_SAVE, **opts)
            t_make = time.perf_counter() - t0
            same_mesh = (np.array_equal(fs.mesh.coords, mesh.coords)
                         and np.array_equal(fs.mesh.cells, mesh.cells))
            log(f"phase 40: h5py installed: {h5py_installed}, unimportable for the phase; the "
                f"default mesh ({mesh.num_cells} cells, {fs.space.n_dofs} dofs) written in "
                f"{t_write_mesh * 1e3:.1f} ms ({mesh_bytes} bytes), make_default(meshpath=...) {t_make:.2f} s; cells and coordinates "
                f"bitwise the generated mesh's: {same_mesh}")
            if not same_mesh or fs.space.n_dofs != NDOFS_REF:
                raise AssertionError("phase 40: the mesh read back differs from the generated one")
            # 2. the base flow through steady/
            write_field_snapshot(fs.paths.U0, "U0", u0, 0.0, append=False)
            write_field_snapshot(fs.paths.P0, "P0", p0, 0.0, append=False)
            fs.paths.steady_meta.write_text(json.dumps({"mesh_cells": fs.mesh.num_cells}))
            fs.load_steady_state()
            same_base = (np.array_equal(fs.fields.U0, u0) and np.array_equal(fs.fields.P0, p0))
            log(f"phase 40: phase 3's base flow written to steady/ and read back by "
                f"load_steady_state(): bitwise equal: {same_base}")
            if not same_base:
                raise AssertionError("phase 40: the base flow read back differs")
            # 3. the continuous closed loop with checkpoints
            fs.initialize_time_stepping()
            for cnt in counters:
                cnt.launches = 0
            # both Steppers stream phase 6's entry (phase 42 builds the factor cold)
            os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = str(factors)
            t0 = time.perf_counter()
            st = fs.stepper
            torch.cuda.synchronize()
            t_factor = time.perf_counter() - t0
            dt = fs.params_time.dt
            (a, b, c, d), _, _ = controller_population(st, dt)
            k = Controller.from_matrices(A=a, B=b, C=c, D=d)
            y, ys, kx = fs.y_meas, [], None
            t0 = time.perf_counter()
            for i in range(RESTART_STEPS):
                y = fs.step(k.step(-y[:1], dt))
                ys.append(y)
                if i + 1 == RESTART_SAVE:
                    kx = k.x.copy()
            torch.cuda.synchronize()
            t_run = time.perf_counter() - t0
            ys = np.asarray(ys)
            launches = [cnt.launches for cnt in counters]
            solves = (1 + st.BORROW_ITERS) + (RESTART_STEPS - 1) * 2
            want = [RESTART_STEPS + 1, 0, 0, 0, solves, 0, 0]
            mf = st._solvers[-1]
            loaded = mf.loaded_from
            log(f"phase 40: continuous run: solve kinds {st._solver_kinds}; Stepper built in "
                f"{t_factor:.2f} s (factor loaded_from {mf.loaded_from!r}; host multifrontal: "
                f"ordering+f64 factorization {mf.timings['ordering+factorization']:.2f} s, total "
                f"{mf.timings['total']:.2f} s; BDF1 kept as the borrowed step's f64 operator); {RESTART_STEPS} steps of the "
                f"closed loop with checkpoints at {RESTART_SAVE} and {RESTART_STEPS} in "
                f"{t_run:.2f} s; launches K1/K2/P1/K3/F/S/R {launches} (expected {want})")
            if launches != want or not np.isfinite(ys).all():
                raise AssertionError(f"phase 40: continuous run launches {launches} or y not finite")
            meta = json.loads(fs.paths.metadata.read_text())
            n_rows = len(fs.paths.timeseries.read_text().splitlines())
            log(f"phase 40: sidecar {fs.paths.metadata.name}: {meta}; CSV "
                f"{fs.paths.timeseries.name}: {n_rows} lines")
            if meta["checkpoints_written"] != RESTART_STEPS // RESTART_SAVE or \
                    n_rows != RESTART_STEPS + 2:
                raise AssertionError("phase 40: sidecar or CSV not as written")
            del st, mf
            fs._stepper = fs._carry = fs._step_compiled = None
            free_card()
            # 4. the restart from the sidecar
            t_restart = RESTART_SAVE * dt
            fs2 = CylinderFlowSolver.make_default(num_steps=RESTART_STEPS - RESTART_SAVE,
                                                  Tstart=t_restart, **opts)
            fs2.load_steady_state()
            t0 = time.perf_counter()
            fs2.initialize_time_stepping(Tstart=t_restart)
            t_read = time.perf_counter() - t0
            t0 = time.perf_counter()
            st2 = fs2.stepper
            torch.cuda.synchronize()
            t_factor2 = time.perf_counter() - t0
            os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = "off"
            mf2 = st2._solvers[-1]
            if (loaded, mf2.loaded_from) != ("stream", "stream"):
                raise AssertionError(f"phase 40: the factors came from {loaded!r}, "
                                     f"{mf2.loaded_from!r}, not phase 6's entry")
            for cnt in counters:
                cnt.launches = 0
            k.x = kx.copy()
            y, ys2 = ys[RESTART_SAVE - 1], []
            for _ in range(RESTART_STEPS - RESTART_SAVE):
                y = fs2.step(k.step(-y[:1], dt))
                ys2.append(y)
            torch.cuda.synchronize()
            launches2 = [cnt.launches for cnt in counters]
            n2 = RESTART_STEPS - RESTART_SAVE
            want2 = [n2, 0, 0, 0, 2 * n2, 0, 0]
            tail = ys[RESTART_SAVE:]
            err = float(np.abs(np.asarray(ys2) - tail).max() / np.abs(tail).max())
            log(f"phase 40: restart at T = {t_restart:g} from the sidecar ({t_read * 1e3:.1f} ms "
                f"to find and read it): order {fs2.order}, solve kinds {st2._solver_kinds}, "
                f"{len(st2._solvers)} system built, borrowed operator: {bool(st2._dev['a_bc'])}; "
                f"Stepper built in {t_factor2:.2f} s (loaded_from {mf2.loaded_from!r}; "
                f"ordering+f64 factorization "
                f"{mf2.timings['ordering+factorization']:.2f} s, total {mf2.timings['total']:.2f} "
                f"s), the continuous run's {t_factor:.2f} s")
            log(f"phase 40: {n2} restarted steps: launches K1/K2/P1/K3/F/S/R {launches2} "
                f"(expected {want2}: K1 one a step, F two a step, no borrowed sweep); "
                f"max|y_restart - y_continuous| / max|y_continuous| over steps "
                f"{RESTART_SAVE + 1}-{RESTART_STEPS}: {err:.3e} (tol {RESTART_TOL:g}); "
                f"y[-1] {np.asarray(ys2)[-1].tolist()} | {tail[-1].tolist()}")
            if (fs2.order != 2 or st2._solver_kinds != ["multifrontal"] or st2._dev["a_bc"]
                    or launches2 != want2 or not err <= RESTART_TOL):
                raise AssertionError(f"phase 40: the restart: order {fs2.order}, kinds "
                                     f"{st2._solver_kinds}, launches {launches2}, error {err}")
            # 5. the files: one checkpoint's write and read, its bytes, the indexes
            io_dir = out / "io"
            paths = dataclasses.replace(
                fs.paths, U_restart=io_dir / "U.ckpt", Uprev_restart=io_dir / "Uprev.ckpt",
                P_restart=io_dir / "P.ckpt", metadata=io_dir / "meta.json")
            ex = FlowExporter(paths, fs.fields, fs.space, dt=dt, save_every=RESTART_SAVE)
            writes = []
            for j in range(3):
                t0 = time.perf_counter()
                ex.export_snapshots(fs.fields.u_n, fs.fields.u_nn, fs.fields.p_n, time=j * dt,
                                    adjust_baseflow=1.0)
                ex.write_metadata()
                ex.write_paraview_index()
                writes.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            for path, name in ((fs.paths.U_restart, "U"), (fs.paths.Uprev_restart, "U_n"),
                               (fs.paths.P_restart, "P")):
                read_field_snapshot(path, name, -1)
            t_read_ckpt = (time.perf_counter() - t0) * 1e3
            snap_bytes = sum(f.stat().st_size for f in (
                fs.paths.U_restart / "U" / "1.npy", fs.paths.Uprev_restart / "U_n" / "1.npy",
                fs.paths.P_restart / "P" / "1.npy"))
            viz_bytes = sum(f.stat().st_size for f in (
                fs.paths.U_restart / "viz" / "U" / "1.npy",
                fs.paths.P_restart / "viz" / "P" / "1.npy"))
            index_bytes = sum(p.with_suffix(".xdmf").stat().st_size
                              for p in (fs.paths.U_restart, fs.paths.P_restart))
            nv = fs.mesh.num_vertices
            checked = 0
            for path, name in ((fs.paths.U_restart, "U"), (fs.paths.P_restart, "P")):
                xdmf = path.with_suffix(".xdmf")
                for grid in ET.parse(xdmf).getroot().findall(".//Grid[@GridType='Uniform']"):
                    kk = int(grid.get("Name").rsplit("_", 1)[1])
                    snap = np.load(path / name / f"{kk}.npy")[:nv]
                    if name == "U":
                        snap = np.pad(snap, ((0, 0), (0, 1)))
                    got = {tag: read_data_item(grid.find(f"{tag}/DataItem"), xdmf.parent)
                           for tag in ("Attribute", "Geometry", "Topology")}
                    if not (got["Attribute"].dtype == snap.dtype
                            and np.array_equal(got["Attribute"], snap)
                            and np.array_equal(got["Geometry"], fs.mesh.coords)
                            and np.array_equal(got["Topology"], fs.mesh.cells)):
                        raise AssertionError(f"phase 40: {xdmf.name} grid {kk} differs from "
                                             f"the vertex slice")
                    checked += 1
            log(f"phase 40: one checkpoint (three snapshot files, the sidecar, the U and P "
                f"indexes) written in {', '.join(f'{w:.1f}' for w in writes)} ms (first, second, "
                f"third into a new directory), read back (U, U_n, P) in {t_read_ckpt:.1f} ms; "
                f"bytes on disk per checkpoint: {snap_bytes} of snapshots (f64) + {viz_bytes} "
                f"of vertex slices, beside the sidecar's {fs.paths.metadata.stat().st_size} and "
                f"the indexes' {index_bytes} (rewritten at every checkpoint); {checked} grids of the U and P indexes: every "
                f"Binary DataItem read at its Seek equals the vertex slice, the mesh's "
                f"coordinates and cells; the phase took {time.perf_counter() - t_phase:.1f} s "
                f"({card})")
            del fs, st2, mf2
            fs2._stepper = fs2._carry = fs2._step_compiled = None
            free_card()
            # ── phase 42: the factor cache on the restart's traffic ─────────
            cached = cache_phase(opts, t_restart, k, kx, ys[RESTART_SAVE - 1], np.asarray(ys2),
                                 counters, card)
            del fs2
    finally:
        os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = "off"
        if saved is None:
            sys.modules.pop("h5py", None)
        else:
            sys.modules["h5py"] = saved
    free_card()
    return cached


#: phase 41's single stream: phase 3's controls (10 steps, where 20 would
#: cost ~13 s more; the run's time limit)
KRYLOV_STEPS = 10
#: phase 41's krylov_rtol (stepper_options): the JAX package's default,
#: which the port's Krylov solve reaches (it runs in f64 inside the f32
#: step); the same cycles in f32 diverge (the floor study)
KRYLOV_RTOL = 1e-8
KRYLOV_FLOOR_CYCLES = 2  # cycles of the floor study
BICG_STEPS = 3
KRYLOV_BATCH = 4
KRYLOV_BATCH_STEPS = 3
#: phase 41's stepper_options
KRYLOV_OPTIONS = {"krylov_rtol": KRYLOV_RTOL}


def krylov_products(st, cycles: int, steps: int) -> int:
    """The sparse products (S's csr_matmul at a batch) of ``steps`` Krylov
    steps that ran ``cycles`` cycles in all: per GMRES cycle the start's
    M(b - A x) (A once, SIMPLE's M four times), each of gmres_iters restarts'
    gmres_iters Arnoldi steps M(A v) and its closing residual, and the
    cycle's measured residual (BiCGStab: b - A x0, then per iteration two M
    and two A); per step the mass apply."""
    it = st.gmres_iters
    per_cycle = 5 + it * (5 * it + 5) if st.backend == "gmres" else 1 + 10 * it
    return cycles * (per_cycle + 1) + steps


def krylov_phase(u0: np.ndarray, p0: np.ndarray, host, counters, card: str) -> dict:
    """Phase 41: the Krylov backends at the default cylinder's 56,383 dofs in
    f32 on a card holding nothing else, from phase 3's host base flow.
    Returns the phase's K1 and S launches (for the kernels line)."""
    from flowcontrol_tpu_torch.core.stepper import carry_to_numpy
    from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver
    from flowcontrol_tpu_torch.solvers.krylov import gmres

    t_phase = time.perf_counter()
    total = [0] * len(counters)

    def take():
        got = [c.launches for c in counters]
        for i, g in enumerate(got):
            total[i] += g
        for c in counters:
            c.launches = 0
        return got

    def solver(backend, steps):
        fs = CylinderFlowSolver.make_default(
            Re=RE, num_steps=steps, device="cuda", solver_backend=backend,
            stepper_options=dict(KRYLOV_OPTIONS))
        fs._assign_steady_state(u0, p0)
        fs.initialize_time_stepping()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        st = fs.stepper  # the systems, the SIMPLE preconditioners, init_carry
        torch.cuda.synchronize()
        return fs, st, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    fs, st, t_setup = solver("gmres", KRYLOV_STEPS)
    pcs = [pc for _, pc in st._solvers]
    log(f"phase 41: GMRES at {fs.space.n_dofs} dofs, a {st.dtype} step on {st.device} (its "
        f"Krylov solve in f64), solve kinds {st._solver_kinds}; krylov_rtol "
        f"{st.krylov_rtol:g} (stepper_options), gmres_iters {st.gmres_iters} (a cycle: up to "
        f"{st.gmres_iters} restarts of {st.gmres_iters} Arnoldi steps), at most "
        f"{st.krylov_max_cycles} cycles; Stepper built in {t_setup:.2f} s, of it the SIMPLE "
        f"preconditioners' host builds (BDF1, BDF2) "
        f"{', '.join(f'{pc.build_seconds:.2f}' for pc in pcs)} s; Schur inverse "
        f"{tuple(pcs[-1].s_inv.shape)} {pcs[-1].s_inv.dtype}, {pcs[-1].s_inv.nbytes / 1e6:.1f} MB "
        f"per order; peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    # the single stream: events around each step (its span on the device's
    # timeline: each cycle waits on the host for its residual, so the span
    # holds the card's idle gaps too), the host's wall time
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ys, steps, carry10, cyc0 = [], [], None, st.krylov_cycles
    t_run = time.perf_counter()
    for i in range(KRYLOV_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        ys.append(fs.step(controls(i)))
        end.record()
        torch.cuda.synchronize()
        steps.append((st.last_krylov_cycles, fs.last_solve_res, start.elapsed_time(end),
                      (time.perf_counter() - t0) * 1e3))
        if i + 1 == CTRL_STEPS:
            carry10 = carry_to_numpy(fs._carry)
    t_run = time.perf_counter() - t_run
    launches = take()
    cycles = st.krylov_cycles - cyc0
    ys = np.asarray(ys)
    want = [KRYLOV_STEPS + 1, 0, 0, 0, 0, 0, 0]
    log(f"phase 41: {KRYLOV_STEPS} fs.step calls (u = [0.3, -0.2] for {CTRL_STEPS}, then 0) in "
        f"{t_run:.2f} s ({KRYLOV_STEPS / t_run:.2f} steps/s; {card}); per step (cycles, Arnoldi "
        f"steps, res, device-timeline span ms, host ms): "
        + "; ".join(f"{c}, {c * st.gmres_iters ** 2}, {r:.3e}, {s:.1f}, {w:.1f}"
                    for c, r, s, w in steps))
    log(f"phase 41: y[-1] = {ys[-1].tolist()}; launches K1/K2/P1/K3/F/S/R {launches} (expected "
        f"{want}: K1 once a step and in init_carry; one vector's products are cuSPARSE SpMVs)")
    if not (np.isfinite(ys).all() and all(r >= 0.0 for _, r, _, _ in steps)):
        raise AssertionError("phase 41: y not finite or a residual not measured")
    if launches != want:
        raise AssertionError(f"phase 41: single-stream launches {launches}, expected {want}")
    # where a Krylov step's time goes: one step under torch.profiler,
    # device activity alone (a GMRES step makes ~80,000 launches, whose host
    # records would take longer to gather than the step)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fs.step(np.zeros(st.n_act))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kinds = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                    if str(getattr(e, "device_type", "")).endswith("CUDA")), reverse=True)
    busy = sum(k[0] for k in kinds)
    log(f"phase 41: one GMRES step ({st.last_krylov_cycles} cycle(s)) profiled: {wall:.1f} ms "
        f"wall, device busy {busy:.1f} ms ({busy / wall:.3f}), {sum(k[1] for k in kinds)} "
        f"launches; by kind (ms, launches): "
        + "; ".join(f"{name[:60]} {ms:.1f}, {n}" for ms, n, name in kinds[:6]))
    take()
    # the floor: from the state after the steps, the next step's system
    # (zero control) solved cycle after cycle, each cycle's relative
    # residual (in f64), by the Stepper's f64 solve and by the same GMRES
    # and SIMPLE in f32 (the JAX package's arithmetic on the card)
    from flowcontrol_tpu_torch.fem.assembly import to_scipy_csr
    from flowcontrol_tpu_torch.core.stepper import csr_to_device
    from flowcontrol_tpu_torch.solvers.krylov import CsrOperator, build_simple_preconditioner

    a_bc, _ = fs._bcset_perturbation().eliminate_csr(to_scipy_csr(
        fs.forms.transient_lhs(2, fs.fields.U0), fs.space.cell_dofs, fs.space.n_dofs))
    op64, pc64 = st._solvers[st._order_idx[2]]
    op32 = CsrOperator(csr_to_device(a_bc, st.device, torch.float32))
    pc32 = build_simple_preconditioner(a_bc, None, fs.space.n_vel_dofs, op32, st.device,
                                       torch.float32)
    carry = fs._carry
    rhs = st._rhs(2, carry, torch.zeros(st.n_act, dtype=st.dtype, device=st.device),
                  st._nl(carry.u_n)).double()
    floor = {}
    for name, op, pc, dt in (("f64", op64, pc64, torch.float64),
                             ("f32", op32, pc32, torch.float32)):
        x, b, rows = carry.u_n.to(dt), rhs.to(dt), []
        for _ in range(KRYLOV_FLOOR_CYCLES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, _ = gmres(op.apply, b, x0=x, M=pc.apply, tol=0.0, restart=st.gmres_iters,
                         maxiter=st.gmres_iters)
            r = float(torch.linalg.vector_norm(rhs - op64.apply(x.double()))
                      / torch.linalg.vector_norm(rhs))
            torch.cuda.synchronize()
            rows.append((r, (time.perf_counter() - t0) * 1e3))
        floor[name] = rows
    take()
    log(f"phase 41: the floor: the next BDF2 system solved for {KRYLOV_FLOOR_CYCLES} GMRES "
        f"cycles from the carry, the relative residual (f64) after each cycle (ms a cycle): "
        + "; ".join(f"{name}: " + ", ".join(f"{r:.3e} ({ms:.0f})" for r, ms in rows)
                    for name, rows in floor.items())
        + f"; krylov_rtol {st.krylov_rtol:g}: the f64 solve's floor "
        f"{min(r for r, _ in floor['f64']):.3e}; in f32 the JAX package's GMRES ends at "
        f"{floor['f32'][-1][0]:.3e} (its single Gram-Schmidt pass and normal equations)")
    if not min(r for r, _ in floor["f64"]) <= st.krylov_rtol:
        raise AssertionError(f"phase 41: the f64 solve's floor {floor['f64']}")
    del op32, pc32, a_bc
    # phase 4's accuracy: 10 more steps from the carry after step 10
    acc = accuracy(host, st, carry10, "phase 41")
    take()
    t_single = time.perf_counter() - t_phase
    # a batch: KRYLOV_BATCH copies of the state after the steps, distinct
    # controls, one joint Krylov solve a step (S for every product)
    up = fs._carry.u_n.double().cpu().numpy()
    amps = np.linspace(0.5, 1.5, KRYLOV_BATCH)
    u_seq = np.tile(amps[:, None] * np.asarray([0.3, -0.2]), (KRYLOV_BATCH_STEPS, 1, 1))
    up_b = torch.as_tensor(up, dtype=st.dtype, device=st.device).expand(KRYLOV_BATCH, -1)
    cyc0 = st.krylov_cycles
    t0 = time.perf_counter()
    carry_b, out_b = st.rollout_open_loop(st.init_carry(up_b.contiguous()), u_seq)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    launches_b = take()
    want_b = [KRYLOV_BATCH_STEPS + 1, 0, 0, 0, 0,
              krylov_products(st, st.krylov_cycles - cyc0, KRYLOV_BATCH_STEPS) + 1, 0]
    _, out_1 = st.rollout_open_loop(st.init_carry(up), u_seq[:, 0])
    take()
    y_err = rel_err(out_b.y[:, 0], out_1.y)[0]
    log(f"phase 41: B={KRYLOV_BATCH} rollout_open_loop of {KRYLOV_BATCH_STEPS} steps (controls "
        f"linspace(0.5, 1.5) x [0.3, -0.2]) in {t_batch:.2f} s, {st.krylov_cycles - cyc0} "
        f"cycles, res per step {out_b.res.cpu().numpy().tolist()}; launches K1/K2/P1/K3/F/S/R "
        f"{launches_b} (expected {want_b}: S for the mass and every Krylov product); member 0 "
        f"against its single stream: y max|b-s|/max|s| {y_err:.3e} (tol {MEMBER_TOL:g}; one "
        f"joint solve: each member's step depends on its companions within krylov_rtol)")
    if launches_b != want_b or not y_err <= MEMBER_TOL or not bool(torch.isfinite(out_b.y).all()):
        raise AssertionError(f"phase 41: the batch: launches {launches_b}, member 0 {y_err:.3e}")
    del fs, st, op, pc, op64, pc64, carry, carry_b, x, rhs
    free_card()
    # BiCGStab, single stream
    fs, st, t_setup = solver("bicgstab", BICG_STEPS)
    res = []
    t0 = time.perf_counter()
    for i in range(BICG_STEPS):
        y = fs.step(controls(i))
        res.append((st.last_krylov_cycles, fs.last_solve_res))
    torch.cuda.synchronize()
    t_bicg = time.perf_counter() - t0
    launches_c = take()
    log(f"phase 41: BiCGStab: Stepper built in {t_setup:.2f} s; {BICG_STEPS} steps in "
        f"{t_bicg:.2f} s, (cycles, res) per step {res}, y[-1] = {np.asarray(y).tolist()}; "
        f"launches K1/K2/P1/K3/F/S/R {launches_c}")
    if not (np.isfinite(y).all() and all(r >= 0.0 for _, r in res)
            and launches_c[0] == BICG_STEPS + 1):
        raise AssertionError(f"phase 41: BiCGStab y {y}, res {res}, launches {launches_c}")
    del fs, st
    free_card()
    log(f"phase 41: field error {acc:.3e}; the phase took {time.perf_counter() - t_phase:.1f} s "
        f"(single stream and accuracy {t_single:.1f} s; {card})")
    return dict(k1=total[0], s=total[5], r=total[6])


def cache_phase(opts: dict, t_restart: float, k, kx: np.ndarray, y_restart: np.ndarray,
                ys_restart: np.ndarray, counters, card: str) -> dict:
    """Phase 42: the factor cache on phase 40's restart. The restarted
    cylinder's Stepper (BDF2 alone, multifrontal) built three times with the
    cache in a new directory: cold, from the streamed derived entry, and
    from the primary entry; F's solves and measured errors bitwise equal;
    phase 40's restarted steps rerun on the streamed factor, y bitwise
    equal. Then one factor with the knobs inbox='full', FC_MF_PACK=bucket
    and trim=False: F and the per-stage sweep against plain. Returns F's
    launches of the rerun."""
    from flowcontrol_tpu_torch.fem.assembly import to_scipy_csr
    from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver
    from flowcontrol_tpu_torch.ops.mf_fused import (
        multifrontal_solve_fused,
        multifrontal_solve_fused_plain,
    )
    from flowcontrol_tpu_torch.parallel.dofsharding import mixed_dof_coordinates
    from flowcontrol_tpu_torch.solvers import factor_cache
    from flowcontrol_tpu_torch.solvers.multifrontal import (
        DERIVED_TAG,
        MultifrontalLU,
        multifrontal_solve,
    )

    t_phase = time.perf_counter()
    n2 = RESTART_STEPS - RESTART_SAVE
    env = {k_: os.environ.get(k_) for k_ in ("FLOWCONTROL_TPU_FACTOR_CACHE", "FC_MF_PACK")}

    def build():
        fs = CylinderFlowSolver.make_default(num_steps=n2, Tstart=t_restart, **opts)
        fs.load_steady_state()
        fs.initialize_time_stepping(Tstart=t_restart)
        t0 = time.perf_counter()
        st = fs.stepper
        torch.cuda.synchronize()
        return fs, st._solvers[-1], time.perf_counter() - t0

    def size(p: Path) -> int:
        return sum(f.stat().st_size for f in p.iterdir())

    cache = Path(tempfile.mkdtemp(prefix="chip_smoke_factor_cache_"))
    try:
        os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = str(cache)
        built = []
        fs_cold, mf, t_st = build()
        t0 = time.perf_counter()
        factor_cache.flush()
        t_flush = time.perf_counter() - t0
        built.append(("cold", mf, t_st))
        del fs_cold
        entries = {p.name: size(p) for p in cache.iterdir()}
        (derived,) = [p for p in cache.iterdir() if DERIVED_TAG in p.name]
        fs, mf, t_st = build()
        built.append(("again", mf, t_st))
        # the derived entry's files read alone, after the streamed load (the
        # page cache warm for both)
        t0 = time.perf_counter()
        for f in derived.iterdir():
            np.load(f)
        t_read = time.perf_counter() - t0
        shutil.rmtree(derived)
        fs_p, mf, t_st = build()
        built.append(("derived entry removed", mf, t_st))
        del fs_p
        factor_cache.flush()
        kinds = [m.loaded_from for _, m, _ in built]
        for name, m, t_st in built:
            log(f"phase 42: {name}: loaded_from {m.loaded_from!r}; Stepper built in {t_st:.2f} s; "
                "multifrontal set-up s: "
                + ", ".join(f"{k_} {v:.2f}" for k_, v in m.timings.items())
                + f"; solve_err {m.solve_err:.6e}")
        d_bytes = entries[derived.name]
        p_bytes = sum(v for k_, v in entries.items() if k_ != derived.name)
        log(f"phase 42: entries on disk: primary {p_bytes / 1e9:.4f} GB, derived "
            f"{d_bytes / 1e9:.4f} GB (written in the background; the flush after the cold "
            f"build waited {t_flush:.2f} s); the streamed load {d_bytes / 1e9 / built[1][1].timings['load']:.2f} "
            f"GB/s (read and copied to the card), the same files read alone (np.load, warm page "
            f"cache) {d_bytes / 1e9 / t_read:.2f} GB/s; {card}")
        b = torch.as_tensor(np.random.default_rng(7).standard_normal(mf.n), dtype=torch.float32,
                            device=mf.device)
        xs = [m.solve(b) for _, m, _ in built]
        same = all(torch.equal(x, xs[0]) for x in xs) and len({m.solve_err for _, m, _ in built}) == 1
        log(f"phase 42: F's solve of one right-hand side bitwise equal across the three "
            f"factors, solve_err equal: {same}")
        if kinds != ["build", "stream", "primary"] or not same:
            raise AssertionError(f"phase 42: loaded_from {kinds}, bitwise {same}")
        del built, xs
        mf_default = fs.stepper._solvers[-1]
        # phase 40's restarted steps on the streamed factor
        dt = fs.params_time.dt
        for c in counters:
            c.launches = 0
        k.x = kx.copy()
        y, ys = y_restart, []
        for _ in range(n2):
            y = fs.step(k.step(-y[:1], dt))
            ys.append(y)
        torch.cuda.synchronize()
        launches = [c.launches for c in counters]
        same_y = bool(np.array_equal(np.asarray(ys), ys_restart))
        log(f"phase 42: phase 40's {n2} restarted steps on the streamed factor: y bitwise equal "
            f"to phase 40's: {same_y}; launches K1/K2/P1/K3/F/S/R {launches}")
        if not same_y or launches != [n2, 0, 0, 0, 2 * n2, 0, 0]:
            raise AssertionError(f"phase 42: the rerun: bitwise {same_y}, launches {launches}")
        # the knobs, cache off
        os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = "off"
        os.environ["FC_MF_PACK"] = "bucket"
        lhs = to_scipy_csr(fs.forms.transient_lhs(2, fs.fields.U0), fs.space.cell_dofs,
                           fs.space.n_dofs)
        a_bc, _ = fs._bcset_perturbation().eliminate_csr(lhs)
        t0 = time.perf_counter()
        mfk = MultifrontalLU(a_bc, mixed_dof_coordinates(fs.space), mf_default.device,
                             dtype=torch.float32, inbox="full", trim=False)
        t_k = time.perf_counter() - t0
        rng = np.random.default_rng(8)
        errs, times = {}, {}
        for rows in (1, 8, 64):
            bb = torch.as_tensor(rng.standard_normal((rows, mfk.n)), dtype=torch.float32,
                                 device=mfk.device)
            if rows <= 8:
                got = multifrontal_solve_fused(mfk, bb)
            else:
                got = multifrontal_solve(mfk, bb)
            errs[rows] = rel_err(got, multifrontal_solve_fused_plain(mfk, bb))[0]
            for name, m in (("knobs", mfk), ("default", mf_default)):
                if rows <= 8:
                    times[name, rows] = queued_ms(lambda: multifrontal_solve_fused(m, bb))[0]
                else:
                    times[name, rows] = device_ms([lambda: multifrontal_solve(m, bb)], reps=5)
        log(f"phase 42: knob factor (inbox='full', FC_MF_PACK=bucket, trim=False) built in "
            f"{t_k:.2f} s: {len(mfk.stages)} stages ({len(mf_default.stages)} by default), factor "
            f"stacks {mfk.factor_bytes / 1e9:.4f} GB ({mf_default.factor_bytes / 1e9:.4f}), "
            f"max_front {mfk.max_front} ({mf_default.max_front}), solve_err {mfk.solve_err:.3e}; "
            f"against plain: F rows 1 {errs[1]:.3e}, rows 8 {errs[8]:.3e} (tol {F_TOL:g}), the "
            f"per-stage sweep (K2, P1) at B=64 {errs[64]:.3e} (tol {MF_TOL:g}); device ms per solve "
            f"knobs | default: F rows 1 {times['knobs', 1]:.4f} | {times['default', 1]:.4f}, "
            f"rows 8 {times['knobs', 8]:.4f} | {times['default', 8]:.4f} (queued events), sweep "
            f"B=64 {times['knobs', 64]:.4f} | {times['default', 64]:.4f} (profiler); {card}")
        if not (errs[1] <= F_TOL and errs[8] <= F_TOL and errs[64] <= MF_TOL):
            raise AssertionError(f"phase 42: the knob factor against plain: {errs}")
        del fs, mf, mf_default, mfk
    finally:
        for k_, v in env.items():
            if v is None:
                os.environ.pop(k_, None)
            else:
                os.environ[k_] = v
        shutil.rmtree(cache, ignore_errors=True)
    log(f"phase 42: the phase took {time.perf_counter() - t_phase:.1f} s ({card})")
    return dict(f=launches[4])


# ── The half-million-dof cylinder (phase 46) ─────────────────────────────────

BIG_NDOFS = 506_553  # tools/scale_big.py's mesh at density 30
BIG_STEPS = 50  # tools/scale_big.py's rollout
# BLAS and torch threads of the factor's host build, which runs in a child
# process beside the earlier phases from the top of the run
BIG_CHILD_THREADS = 3
BIG_CHILD_TIMEOUT = 900  # seconds phase 46 waits for that build at most
# the f64 reference's solve: F's f32 solves refined against the f64
# residual until it is below BIG_REF_RES relative to the right-hand side
BIG_REF_RES = 1e-12
BIG_REF_SWEEPS = 12
BIG_PIN = 1e-4  # the port's f32 rule: the 10-step field error against f64


def cavity_solver(device, **kw):
    """Phase 17's open cavity (the child builds its factor on the host)."""
    from flowcontrol_tpu_torch.models.cavity import CavityFlowSolver

    return CavityFlowSolver.make_default(Re=CAV_RE, num_steps=NUM_STEPS, device=device, **kw)


def lid_solver(device, **kw):
    """Phase 23's lid-driven cavity."""
    from flowcontrol_tpu_torch.models.lidcavity import LidCavityFlowSolver

    return LidCavityFlowSolver.make_default(Re=LID_RE, num_steps=NUM_STEPS, device=device, **kw)


def pinball_solver(device, **kw):
    """Phase 27's fluidic pinball (rotation, the multifrontal solve)."""
    from flowcontrol_tpu_torch.core.actuator import CYLINDER_ACTUATION_MODE
    from flowcontrol_tpu_torch.models.pinball import PinballFlowSolver

    return PinballFlowSolver.make_default(
        Re=PIN_RE, num_steps=NUM_STEPS, device=device,
        mode_actuation=CYLINDER_ACTUATION_MODE.ROTATION,
        stepper_options={"force_substructure": True}, **kw)


# the flows whose BDF2 factors the child builds before phase 46's, in the
# order the phases take them
PREBUILT = (("cavity", cavity_solver), ("lidcavity", lid_solver), ("pinball", pinball_solver))


def prebuild_factors(cache: Path) -> int:
    """The child process's work (``python3 chip_smoke.py --prebuild
    CACHE``): the multifrontal factors of the PREBUILT flows, then phase
    46's (``tools/scale_big.py`` ``factor``), built on the host (the CPU,
    f32, the multifrontal solve: 'auto' takes the host LU on the CPU) into
    the factor cache ``cache``, each
    announced by a line ``READY <name>: <report>`` once its entries are
    written."""
    from flowcontrol_tpu_torch.models.make_baseflow import CYLINDER_BIG_DENSITY
    from flowcontrol_tpu_torch.solvers import factor_cache
    from flowcontrol_tpu_torch.tools import scale_big

    os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = str(cache)
    for name, make in PREBUILT:
        t0 = time.perf_counter()
        fs = make("cpu", precision="f32", solver_backend="dense_lu")
        fs.params_solver.stepper_options = {**fs.params_solver.stepper_options,
                                            "force_substructure": True}
        src, _ = base_flow(fs)
        fs.initialize_time_stepping()
        st = fs.stepper
        factor_cache.flush()
        print(f"READY {name}: base flow {src}; {time.perf_counter() - t0:.2f} s in all; "
              f"{scale_big.factor_report(st)}", flush=True)
        del fs, st
        gc.collect()
    print(f"READY cylinder_big: {scale_big.factor(CYLINDER_BIG_DENSITY, cache)}", flush=True)
    return 0


class FactorChild:
    """The child process that builds factors on the host beside the phases
    (:func:`prebuild_factors`: the CPU, BIG_CHILD_THREADS BLAS threads, no
    card) into the factor cache ``cache``, its output in ``log_path``. A
    phase takes a factor with :meth:`ready`."""

    def __init__(self, cache: Path, log_path: Path):
        self.cache, self.log_path = cache, log_path
        threads = str(BIG_CHILD_THREADS)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS=threads,
                   OPENBLAS_NUM_THREADS=threads, MKL_NUM_THREADS=threads)
        with open(log_path, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--prebuild", str(cache)],
                cwd=Path(__file__).resolve().parent, env=env, stdout=out,
                stderr=subprocess.STDOUT)

    def ready(self, name: str, tag: str) -> str:
        """Wait for the factor ``name`` (BIG_CHILD_TIMEOUT at most) and
        return the child's report of it; fails if the child ended without
        it."""
        t0 = time.perf_counter()
        head = f"READY {name}: "
        while True:
            lines = self.log_path.read_text().splitlines()
            found = [line[len(head):] for line in lines if line.startswith(head)]
            if found:
                break
            if self.proc.poll() is not None or time.perf_counter() - t0 > BIG_CHILD_TIMEOUT:
                for line in lines[-30:]:
                    log(f"{tag} (host build): {line}")
                raise AssertionError(f"{tag}: the host build of the {name} factor ended or ran "
                                     f"past {BIG_CHILD_TIMEOUT} s without it (exit "
                                     f"{self.proc.poll()})")
            time.sleep(0.5)
        log(f"{tag}: the {name} factor built on the host beside the earlier phases "
            f"({BIG_CHILD_THREADS} threads; waited {time.perf_counter() - t0:.1f} s): {found[0]}")
        return found[0]

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def streamed(child: FactorChild, name: str, tag: str, run):
    """``run()`` with the factor cache at the child's directory, once the
    factor ``name`` is there; fails unless the Stepper streamed it."""
    child.ready(name, tag)
    os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = str(child.cache)
    try:
        out = run()
    finally:
        os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = "off"
    st = out["st"]
    mf = st._solvers[st._order_idx[2]]
    if mf.loaded_from != "stream":
        raise AssertionError(f"{tag}: the factor came from {mf.loaded_from!r}, not the host "
                             f"build's entry")
    return out


class RefinedF64Solve:
    """``x = A⁻¹ b`` in float64 for the host reference loop: kernel F's f32
    solve of the factor ``mf``, refined against the f64 residual of ``a64``
    (A in f64 on the card) until it is below BIG_REF_RES relative to b.
    Keeps each solve's sweeps and final residual."""

    def __init__(self, a64: torch.Tensor, mf):
        self.a64, self.mf = a64, mf
        self.sweeps, self.res = [], []

    def __call__(self, rhs: np.ndarray) -> np.ndarray:
        b = torch.as_tensor(rhs, dtype=torch.float64, device=self.a64.device)
        b_norm = float(torch.linalg.vector_norm(b))
        x = self.mf.solve(b.float()).double()
        for k in range(BIG_REF_SWEEPS + 1):
            r = b - torch.mv(self.a64, x)
            res = float(torch.linalg.vector_norm(r)) / b_norm
            if res <= BIG_REF_RES:
                break
            if k == BIG_REF_SWEEPS:
                raise AssertionError(f"the f64 reference's solve stalled at a relative residual "
                                     f"{res:.3e} after {k} sweeps")
            x += self.mf.solve(r.float()).double()
        self.sweeps.append(k)
        self.res.append(res)
        return x.cpu().numpy()


def big_cylinder_phase(counters, card: str, child: FactorChild) -> dict:
    """Phase 46: the half-million-dof cylinder (``tools/scale_big.py``'s
    mesh at density 30) on a card holding nothing of the earlier phases.
    Its BDF2 factor was built on the host by ``child`` while the earlier
    phases ran; this phase waits for it, builds the flow through the tool
    (the committed base flow, or a failure), streams the factor's derived
    entry to the card ('auto' must take the multifrontal solve), runs
    BIG_STEPS ``fs.step`` calls (exact K1 and F launches, the 10-step field
    error against an f64 reference), the tool's two rollouts (the first
    captures; exact launches in the second), the single stream graph
    against eager, F against its plain version and the per-stage sweep at
    this factor, and K1 at this mesh. Returns the kernels line's
    figures."""
    from flowcontrol_tpu_torch.core.stepper import dense_lu_max_dofs_device
    from flowcontrol_tpu_torch.models.baseflows import committed_baseflow, mesh_checksum
    from flowcontrol_tpu_torch.models.make_baseflow import CYLINDER_BIG_DENSITY
    from flowcontrol_tpu_torch.ops.mf_fused import fused_smem_bytes, fused_smem_limit
    from flowcontrol_tpu_torch.tools import scale_big

    tag = "phase 46"
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fs = scale_big.build(CYLINDER_BIG_DENSITY, "dense_lu", "f32", num_steps=BIG_STEPS,
                         device="cuda")
    n = fs.space.n_dofs
    if n != BIG_NDOFS:
        raise AssertionError(f"{tag}: the mesh has {n} dofs, expected {BIG_NDOFS}")
    path = committed_baseflow(fs)
    if path is None:
        raise AssertionError(f"{tag}: no committed base flow matches the mesh (checksum "
                             f"{mesh_checksum(fs.mesh)[:12]})")
    fs.load_steady_state(path)
    fs.initialize_time_stepping()
    t_mesh = time.perf_counter() - t0
    log(f"{tag}: mesh {fs.mesh.num_cells} cells, {n} dofs ({fs.space.n_vel_dofs} velocity + "
        f"{fs.space.n_pressure_dofs} pressure), checksum {mesh_checksum(fs.mesh)[:12]}; base "
        f"flow {path.name} (max|U0| {np.abs(fs.fields.U0).max():.6f}); mesh, spaces, base flow "
        f"and initial state {t_mesh:.2f} s; the dense rule allows {dense_lu_max_dofs_device(dev)} "
        f"dofs on this card")
    big = streamed(child, "cylinder_big", tag, lambda: run_path(fs, counters, steps=BIG_STEPS))
    rc = child.proc.wait(timeout=BIG_CHILD_TIMEOUT)  # its last factor: the child ends
    if rc != 0:
        raise AssertionError(f"{tag}: the host build ended with {rc}")
    st = big["st"]
    oi = st._order_idx[2]
    mf = st._solvers[oi]
    factor_report(tag, st, big)
    solves = (1 + st.BORROW_ITERS) + (BIG_STEPS - 1) * (1 + st._refine.get(oi, 0))
    log(f"{tag}: factor {mf.loaded_from} ({mf.timings['load']:.2f} s to stream "
        f"{mf.factor_bytes / 1e9:.4f} GB of stacks; factorization+init_carry "
        f"{big['t_factor']:.2f} s); {BIG_STEPS} fs.step calls, single-stream {big['sps']:.2f} "
        f"steps/s over the last {BIG_STEPS - CTRL_STEPS} ({card}); y[-1] = "
        f"{big['ys'][-1].tolist()}, dE[-1] = {big['de'][-1]:.6e}")
    for rows in (1, 8):
        need, limit = fused_smem_bytes(mf, rows), fused_smem_limit(rows)
        log(f"{tag}: F at {rows} row(s) asks {need} bytes of shared memory a block of the "
            f"{limit} this card allows ({need / limit:.3f})")
    if st._solver_kinds != ["borrowed", "multifrontal"] or not mf.takes_fused(1):
        raise AssertionError(f"{tag}: solve kinds {st._solver_kinds}")
    expect_launches(tag, big["launches"], [BIG_STEPS + 1, 0, 0, 0, solves, 0, 0],
                    f"{solves} solves, each one launch of F")

    # the f32 pin: 10 steps from the state after CTRL_STEPS against an f64
    # reference whose solves are F's refined to an f64 residual below
    # BIG_REF_RES (no second factorization: a host f64 splu of this matrix
    # takes minutes and ~9 GB)
    ref = RefinedF64Solve(st._dev["a_refine"][oi], mf)
    accuracy(HostF64Loop(fs, solve=ref), st, big["carry10"], tag,
                   against=f"f64 (F refined to an f64 residual below {BIG_REF_RES:g})",
                   tol=BIG_PIN)
    log(f"{tag}: the f64 reference's solves: sweeps {ref.sweeps}, relative f64 residuals "
        f"{max(ref.res):.3e} at most")

    # the tool's rollout: BIG_STEPS steps at u = 0, twice (the first pays
    # for the capture); exact launches in the second
    roll = st.make_rollout_open_loop()
    u_seq = torch.zeros((BIG_STEPS, st.n_act), dtype=st.dtype, device=dev)
    carry = fs._carry
    runs = []
    for _ in range(2):
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, out = roll(carry, u_seq)
        y = out.y.double().cpu().numpy()
        runs.append((time.perf_counter() - t0, [c.launches for c in counters], y))
    (t_first, first, _), (t_replay, replay, y) = runs
    per_step = 1 + st._refine.get(oi, 0)
    log(f"{tag}: the tool's rollout, {BIG_STEPS} steps at u = 0: first run (warm-up and "
        f"capture) {t_first:.2f} s, launches {first}; replay {BIG_STEPS / t_replay:.1f} steps/s "
        f"({card}); y[-1] = {y[-1].tolist()}, bitwise the first run's: "
        f"{bool(np.array_equal(y, runs[0][2]))}")
    expect_launches(tag, replay, [BIG_STEPS, 0, 0, 0, BIG_STEPS * per_step, 0, 0],
                    f"K1 once a step, F {per_step} a step")
    if not (np.isfinite(y).all() and np.array_equal(y, runs[0][2])):
        raise AssertionError(f"{tag}: the rollout's y is not finite or differs between runs")
    phase_graph_rollout(st, carry, "multifrontal", f"{tag}g", steps=BIG_STEPS)

    f_big = phase_fused(mf, tag)
    k1_big = phase_kernel(fs.space, fs.geom, dev, widths=(1,), tag=tag)
    log(f"{tag}: the phase took {time.perf_counter() - t_phase:.1f} s ({card})")
    return dict(n=n, f=f_big, k1=k1_big,
                launches=[a + b for a, b in zip(big["launches"], replay)])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs a CUDA device", file=sys.stderr)
        return 1
    # phases 38, 40 and 43 stream the default cylinder's multifrontal factor
    # that phase 6 builds cold (each cold build costs ~20 s; the run holds
    # its time limit with these three spared)
    factors = Path(tempfile.mkdtemp(prefix="chip_smoke_factors_"))
    # the factors of phases 17, 23, 27 and 46 are built on the host from the
    # start, beside the other phases, into a cache directory of their own
    # (phase 43 copies phase 6's)
    prebuilt = Path(tempfile.mkdtemp(prefix="chip_smoke_prebuilt_"))
    child_log = prebuilt.with_name(prebuilt.name + ".log")
    child = FactorChild(prebuilt, child_log)
    try:
        return run_phases(factors, child)
    finally:
        child.stop()
        for d in (factors, prebuilt):
            shutil.rmtree(d, ignore_errors=True)
        child_log.unlink(missing_ok=True)


def run_phases(factors: Path, child: FactorChild) -> int:
    """Every phase; ``factors``: the factor cache directory phase 6 writes
    and phases 38, 40 and 43 stream; ``child``: the host build of the
    factors phases 17, 23, 27 and 46 stream."""
    import flowcontrol_tpu_torch.solvers.multifrontal as mf_module
    from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver
    from flowcontrol_tpu_torch.ops.mf_fused import (
        F_BLOCK_THREADS,
        MF_FUSED_KERNEL,
        fused_grid,
        multifrontal_solve_fused,
    )
    from flowcontrol_tpu_torch.ops.mf_matvec import MF_KERNELS, stack_matvec, sweep_gather
    from flowcontrol_tpu_torch.ops.nl import NL_KERNEL, nonlinear_convection
    from flowcontrol_tpu_torch.ops.spmm import SPMM_KERNEL, csr_matmul, csr_residual
    from flowcontrol_tpu_torch.ops.trisolve import (
        TRISOLVE_KERNEL,
        block_lu_solve_fused,
        launches_per_solve,
    )
    from flowcontrol_tpu_torch.solvers.block_lu import BlockLU

    t_run = time.perf_counter()
    # the factor cache off but in phases 6 (a cold build kept), 38 and 40
    # (streamed), 42 and 43 (each in a directory of its own; 43's a copy of
    # phase 6's), so that the
    # other set-up numbers keep their meaning (a warm entry would spare the
    # factorization)
    os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = "off"
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # ── phase 1: card, versions, kernel builds ───────────────────────────────
    print(card, flush=True)  # as nvidia-smi gives it: name, power limit
    log(f"phase 1: nvidia-smi: {card}")
    log(f"phase 1: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {kind}, count {torch.cuda.device_count()}")
    # every kernel's nvcc starts now; phases 2-5g need K1 alone, so the
    # others (F's library takes ~100 s) build behind them, until phase 6
    t_build = time.perf_counter()
    kernels = (("K1", NL_KERNEL), ("K2+P1", MF_KERNELS), ("K3", TRISOLVE_KERNEL),
               ("F+P2+P3+P4", MF_FUSED_KERNEL), ("S", SPMM_KERNEL))
    pool = ThreadPoolExecutor(max_workers=len(kernels))
    builds = [pool.submit(lib.get) for _, lib in kernels]
    builds[0].result()
    log(f"phase 1: K1 built in {time.perf_counter() - t_build:.2f} s wall; the other kernels "
        f"build in the background (parallel nvcc) while phases 2-5g run")

    def kernels_built():
        for f in builds:
            f.result()
        pool.shutdown()
        log(f"phase 1: kernels built {time.perf_counter() - t_build:.2f} s after their nvcc "
            f"started (parallel, beside phases 2-5g)")
        for name, lib in kernels:
            log(f"phase 1: {name} built from {lib.source.name} in {lib.build_seconds:.2f} s "
                f"-> {lib.library_path().name}")
            for line in lib.build_log.splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    log(f"phase 1: ptxas: {line.strip()}")
        for rows in (1, 2, 4, 8):
            g = fused_grid(rows)
            log(f"phase 1: F's cooperative grid for {rows} right-hand side(s), node vectors of "
                f"1536 floats and 24 stages: {g['blocks']} blocks of {F_BLOCK_THREADS} threads "
                f"({g['per_sm']} per SM x {g['sms']} SMs)")

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
    counters = (nonlinear_convection, stack_matvec, sweep_gather, block_lu_solve_fused,
                multifrontal_solve_fused, csr_matmul, csr_residual)
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
    log(f"phase 3: launches K1 {k1_launches} (expected {NUM_STEPS + 1}), K2 "
        f"{dense['launches'][1]}, P1 {dense['launches'][2]}, K3 {dense['launches'][3]}, F "
        f"{dense['launches'][4]}, S {dense['launches'][5]}, R {dense['launches'][6]} (expected "
        f"0)")
    m_dev, m_assembled = st._dev["m"].values().numel(), assembled_mass_nnz(st)
    log(f"phase 3: the device mass stores {m_dev} entries, its assembly {m_assembled[0]} "
        f"({m_assembled[1]} of them nonzero)")
    if m_dev != m_assembled[1]:
        raise AssertionError(f"device mass stores {m_dev} entries, {m_assembled[1]} nonzero")
    if dense["launches"] != [NUM_STEPS + 1, 0, 0, 0, 0, 0, 0]:
        raise AssertionError(f"dense path launches {dense['launches']}, "
                             f"expected {[NUM_STEPS + 1, 0, 0, 0, 0, 0, 0]}")

    # ── phase 4: accuracy against host f64 ───────────────────────────────────
    host = HostF64Loop(fs)
    accuracy(host, st, dense["carry10"], "phase 4")

    library_ms = phase_breakdown(fs, st, dev)
    graphs = {"cylinder dense B=1": phase_graph_single(fs, st, "dense", "phase 5g")}

    # ── phase 6: the multifrontal main path ──────────────────────────────────
    kernels_built()
    del st, dense["st"]
    fs._stepper = fs._carry = fs._step_compiled = None  # the dense factor leaves the card
    free_card()
    t0 = time.perf_counter()
    fs2 = CylinderFlowSolver.make_default(
        Re=RE, num_steps=NUM_STEPS, device="cuda",
        stepper_options={"force_substructure": True},
    )
    fs2._assign_steady_state(fs.fields.U0, fs.fields.P0)  # the host Newton, once
    fs2.initialize_time_stepping()
    t_mesh2 = time.perf_counter() - t0
    os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = str(factors)  # built cold, kept for 38, 40, 43
    mfp = run_path(fs2, counters)
    os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = "off"
    st2 = mfp["st"]
    oi2 = st2._order_idx[2]
    mf = st2._solvers[oi2]
    k2_per, p1_per = mf.launches_per_solve()
    solves = (1 + st2.BORROW_ITERS) + (NUM_STEPS - 1) * (1 + st2._refine.get(oi2, 0))
    expected = [NUM_STEPS + 1, 0, 0, 0, solves, 0, 0]
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
    log(f"phase 6: launches K1/K2/P1/K3/F/S/R {mfp['launches']} (expected {expected}: {solves} "
        f"solves, each one launch of F; the per-stage sweep would make {k2_per} K2 and "
        f"{p1_per} P1 launches per solve)")
    if st2._solver_kinds != ["borrowed", "multifrontal"] or not mf.takes_fused(1):
        raise AssertionError(f"solve kinds {st2._solver_kinds}")
    if mfp["launches"] != expected:
        raise AssertionError(f"multifrontal path launches {mfp['launches']}, expected {expected}")

    # ── phase 7: K2 against plain; K2 and P1 at the batched path's width ──────
    k2_narrow = phase_mf_kernels(mf)
    k2_wide = {BATCH: phase_k2_wide(mf, BATCH, "phase 7")}
    solves_per_step2 = 1 + st2._refine.get(oi2, 0)
    p1 = {BATCH: phase_p1(mf, BATCH, solves_per_step2, "phase 7")}

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
    graphs["cylinder multifrontal B=1"] = phase_graph_single(fs2, st2, "multifrontal", "phase 9g")

    # ── phase 10: the block path, single stream ──────────────────────────────
    t0 = time.perf_counter()
    fs3 = CylinderFlowSolver.make_default(
        Re=RE, num_steps=NUM_STEPS, device="cuda", stepper_options={"trisolve": "cuda"},
    )
    fs3._assign_steady_state(fs.fields.U0, fs.fields.P0)
    fs3.initialize_time_stepping()
    t_mesh3 = time.perf_counter() - t0
    blk = run_path(fs3, counters)
    st3 = blk["st"]
    blu = st3._solvers[st3._order_idx[2]]
    refine3 = st3._refine.get(st3._order_idx[2], 0)
    k3_solves = (1 + st3.BORROW_ITERS) + (NUM_STEPS - 1) * (1 + refine3)
    k3_per = launches_per_solve(blu.nb, 1)  # the single stream: one right-hand side
    k3_panel = launches_per_solve(blu.nb, BATCH)  # the batched paths: one persistent launch
    expected = [NUM_STEPS + 1, 0, 0, k3_solves * k3_per, 0, 0, 0]
    y_rel = float(np.abs(blk["ys"][-1] - dense["ys"][-1]).max() / np.abs(dense["ys"][-1]).max())
    log(f"phase 10: solve kinds {st3._solver_kinds} (expected ['borrowed', 'block']), dtype "
        f"{st3.dtype}, refinement sweeps {st3._refine}; BlockLU n_pad {blu.n_pad}, bs {blu.bs}, "
        f"nb {blu.nb}, lu {blu.lu.nbytes / 1e9:.3f} GB + dinv {blu.dinv.nbytes / 1e9:.3f} GB "
        f"{blu.lu.dtype}")
    log(f"phase 10: setup s: mesh+spaces {t_mesh3:.2f}, f64 blocked factorization+init_carry "
        f"{blk['t_factor']:.2f}; peak device memory {blk['peak_gb']:.2f} GB (pivoted path "
        f"{dense['peak_gb']:.2f} GB)")
    log(f"phase 10: {NUM_STEPS} steps, single-stream {blk['sps']:.2f} steps/s over the last "
        f"{NUM_STEPS - CTRL_STEPS} (dense path {dense['sps']:.2f}, multifrontal {mfp['sps']:.2f}; "
        f"{card}); y[-1] = {blk['ys'][-1].tolist()}, relative to the dense path's {y_rel:.3e} "
        f"(tol 1e-3), dE[-1] = {blk['de'][-1]:.6e}")
    log(f"phase 10: launches K1/K2/P1/K3/F/S/R {blk['launches']} (expected {expected}: "
        f"{k3_solves} solves of {k3_per} K3 launches, all made by one call of the C entry point; "
        f"a panel of right-hand sides takes {k3_panel} launch per solve)")
    if st3._solver_kinds != ["borrowed", "block"] or not isinstance(blu, BlockLU):
        raise AssertionError(f"solve kinds {st3._solver_kinds}")
    if blk["launches"] != expected:
        raise AssertionError(f"block path launches {blk['launches']}, expected {expected}")
    if not y_rel <= 1e-3:
        raise AssertionError(f"block path y[-1] differs from the dense path's by {y_rel:.3e}")

    # ── phase 11: K3 against plain ───────────────────────────────────────────
    k3 = phase_k3(blu, library_ms)

    # ── phase 12: accuracy against host f64 ──────────────────────────────────
    accuracy(host, st3, blk["carry10"], "phase 12")
    graphs["cylinder block B=1"] = phase_graph_single(fs3, st3, "block", "phase 12g")

    # ── phase 13: batched open loop, both paths ──────────────────────────────
    up = fs3._carry.u_n.double().cpu().numpy()  # the block path's state after its steps
    solves_b = (1 + st3.BORROW_ITERS) + (BATCH_STEPS - 1) * (1 + refine3)
    open_blk = phase_batched_open(st3, up, counters, "phase 13 (block)")
    open_mf = phase_batched_open(st2, up, counters, "phase 13 (multifrontal)")
    solves_mf = (1 + st2.BORROW_ITERS) + (BATCH_STEPS - 1) * (1 + st2._refine.get(oi2, 0))
    s_blk, s_mf = spmm_launches(st3, BATCH_STEPS, True), spmm_launches(st2, BATCH_STEPS, True)
    expected_open = {"block": [BATCH_STEPS + 1, 0, 0, solves_b * k3_panel, 0, *s_blk],
                     "multifrontal": [BATCH_STEPS + 1, solves_mf * k2_per, solves_mf * p1_per,
                                      0, 0, *s_mf]}
    for name, r in (("block", open_blk), ("multifrontal", open_mf)):
        log(f"phase 13 ({name}): launches K1/K2/P1/K3/F/S/R {r['launches']} "
            f"(expected {expected_open[name]})")
        if r["launches"] != expected_open[name]:
            raise AssertionError(f"batched open loop ({name}) launches {r['launches']}")

    # ── phase 14: batched closed loop, both paths ────────────────────────────
    closed_blk = phase_batched_closed(fs3, st3, open_blk["carry"], open_blk["y_last"], counters,
                                      "phase 14 (block)")
    closed_mf = phase_batched_closed(fs2, st2, open_mf["carry"], open_mf["y_last"], counters,
                                     "phase 14 (multifrontal)")
    per_step_mf = 1 + st2._refine.get(oi2, 0)
    expected_closed = {
        "block": [BATCH_STEPS, 0, 0, BATCH_STEPS * (1 + refine3) * k3_panel, 0,
                  *spmm_launches(st3, BATCH_STEPS, False)],
        "multifrontal": [BATCH_STEPS, BATCH_STEPS * per_step_mf * k2_per,
                         BATCH_STEPS * per_step_mf * p1_per, 0, 0,
                         *spmm_launches(st2, BATCH_STEPS, False)],
    }
    for name, r in (("block", closed_blk), ("multifrontal", closed_mf)):
        log(f"phase 14 ({name}): launches K1/K2/P1/K3/F/S/R {r['launches']} "
            f"(expected {expected_closed[name]})")
        if r["launches"] != expected_closed[name]:
            raise AssertionError(f"batched closed loop ({name}) launches {r['launches']}")
    k3_batched_launches = open_blk["launches"][3] + closed_blk["launches"][3]
    s_launches = [sum(r["launches"][k] for r in (open_blk, open_mf, closed_blk, closed_mf))
                  for k in (5, 6)]
    spmm = {BATCH: phase_spmm(st2, "phase 14s", BATCH)}
    # the batched rollouts as graphs against eager, from the open loops' carries
    k_mats = controller_population(st2, fs2.params_time.dt)[2]
    for name, stp, r, n in (("multifrontal", st2, open_mf, BATCH_STEPS - 1),
                            ("block", st3, open_blk, BLOCK_GRAPH_STEPS)):
        graphs[f"cylinder {name} B={BATCH} open"] = phase_graph_rollout(
            stp, r["carry"], name, "phase 14g", steps=n)
        graphs[f"cylinder {name} B={BATCH} closed"] = phase_graph_rollout(
            stp, r["carry"], name, "phase 14g", k_mats=k_mats, y0=r["y_last"], steps=n)
    k1_batched_launches = sum(r["launches"][0] for r in (open_blk, open_mf, closed_blk, closed_mf))

    # where the multifrontal step's time goes at B = BATCH (the per-stage sweep)
    carry_mf = open_mf["carry"]
    u_mf = torch.zeros((BATCH, st2.n_act), dtype=st2.dtype, device=dev)
    st2.step(carry_mf, u_mf)
    torch.cuda.synchronize()
    profile_steps(fs2, f"phase 14 (multifrontal, B={BATCH})", steps=3,
                  step=lambda: st2.step(carry_mf, u_mf), what="Stepper.step")
    del carry_mf

    # ── phase 15: where the block path's step goes, B = 1 and B = BATCH ──────
    profile_steps(fs3, "phase 15 (B=1)")
    carry_b = open_blk["carry"]
    u_b = torch.zeros((BATCH, st3.n_act), dtype=st3.dtype, device=dev)
    st3.step(carry_b, u_b)
    torch.cuda.synchronize()
    profile_steps(fs3, f"phase 15 (B={BATCH})", steps=3, step=lambda: st3.step(carry_b, u_b),
                  what="Stepper.step")

    # ── phase 16: F against plain and the per-stage sweep; P2, P3, P4 ────────
    f_cyl = phase_fused(mf, "phase 16")
    probes = phase_probes(dev)
    del fs3, st3, blu, carry_b, open_blk, blk["st"]  # the block factor leaves the card
    fs._stepper = fs._carry = fs._step_compiled = None
    free_card()

    # ── phase 17: the open cavity, single stream ─────────────────────────────
    t0 = time.perf_counter()
    fc = cavity_solver("cuda")
    t_mesh_c = time.perf_counter() - t0
    base_src, t_base_c = base_flow(fc)
    fc.initialize_time_stepping()
    cav = streamed(child, "cavity", "phase 17", lambda: run_path(fc, counters, u_on=(CAV_U,)))
    stc = cav["st"]
    oic = stc._order_idx[2]
    mfc = stc._solvers[oic]
    refine_c = stc._refine.get(oic, 0)
    solves_c = (1 + stc.BORROW_ITERS) + (NUM_STEPS - 1) * (1 + refine_c)
    expected = [NUM_STEPS + 1, 0, 0, 0, solves_c, 0, 0]
    t = mfc.timings
    log(f"phase 17: cavity Re={CAV_RE}: mesh {fc.mesh.num_cells} cells, {fc.space.n_dofs} dofs "
        f"({fc.space.n_vel_dofs} velocity + {fc.space.n_pressure_dofs} pressure); mesh+spaces "
        f"{t_mesh_c:.2f} s; base flow {base_src} in {t_base_c:.2f} s, max|U0| "
        f"{np.abs(fc.fields.U0).max():.6f}; stepper_options {fc.params_solver.stepper_options}")
    log(f"phase 17: solve kinds {stc._solver_kinds} (expected ['borrowed', 'multifrontal']), "
        f"dtype {stc.dtype}; host multifrontal s: ordering+f64 factorization "
        f"{t['ordering+factorization']:.2f}, repack {t['repack']:.2f}, error probe "
        f"{t['measure_err']:.2f}, tables {t['tables']:.2f}, upload {t['upload']:.2f}, total "
        f"{t['total']:.2f}; factorization+init_carry {cav['t_factor']:.2f}; peak device memory "
        f"{cav['peak_gb']:.2f} GB")
    log(f"phase 17: {len(mfc.stages)} stages, factor stacks {mfc.factor_bytes / 1e9:.4f} GB, "
        f"{mfc.total_slots} slots, {mfc.total_contrib} contributions; measured per-solve error "
        f"{mfc.solve_err:.3e} (zero-sweep ceiling {mfc.ZERO_SWEEP_ERR:g}), recommended_refine "
        f"{mfc.recommended_refine}, refinement sweeps {stc._refine}; (m, e, b) per stage "
        f"{[(s.m, s.e, s.b) for s in mfc.stages]}")
    log(f"phase 17: {NUM_STEPS} steps (u = [{CAV_U}] for {CTRL_STEPS}, then 0), single-stream "
        f"{cav['sps']:.2f} steps/s over the last {NUM_STEPS - CTRL_STEPS} ({card}); y[-1] = "
        f"{cav['ys'][-1].tolist()}, dE[-1] = {cav['de'][-1]:.6e}")
    log(f"phase 17: launches K1/K2/P1/K3/F/S/R {cav['launches']} (expected {expected}: {solves_c} "
        f"solves, each one launch of F)")
    if (stc._solver_kinds != ["borrowed", "multifrontal"] or fc.params_solver.stepper_options
            or not mfc.takes_fused(1)):
        raise AssertionError(f"cavity solve kinds {stc._solver_kinds}, options "
                             f"{fc.params_solver.stepper_options}")
    if cav["launches"] != expected:
        raise AssertionError(f"cavity launches {cav['launches']}, expected {expected}")

    # ── phase 18: F against plain on the cavity factor ───────────────────────
    f_cav = phase_fused(mfc, "phase 18")

    # ── phase 19: accuracy against host f64 ──────────────────────────────────
    accuracy(HostF64Loop(fc), stc, cav["carry10"], "phase 19")
    log(f"phase 19: refinement sweeps per solve {refine_c} (the factor's recommended_refine: "
        f"per-solve error {mfc.solve_err:.3e} against the {mfc.ZERO_SWEEP_ERR:g} ceiling)")
    graphs["cavity multifrontal B=1"] = phase_graph_single(fc, stc, "multifrontal", "phase 19g")

    # ── phase 20: the cavity, batched open loop (the per-stage sweep) ─────────
    up_c = fc._carry.u_n.double().cpu().numpy()
    open_c = phase_batched_open(stc, up_c, counters, "phase 20", batch=CAV_BATCH, u_dir=(1.0,))
    k2c, p1c = mfc.launches_per_solve()
    solves_bc = (1 + stc.BORROW_ITERS) + (BATCH_STEPS - 1) * (1 + refine_c)
    expected = [BATCH_STEPS + 1, solves_bc * k2c, solves_bc * p1c, 0, 0,
                *spmm_launches(stc, BATCH_STEPS, True)]
    log(f"phase 20: launches K1/K2/P1/K3/F/S/R {open_c['launches']} (expected {expected}: "
        f"{solves_bc} solves x {k2c} K2 and {p1c} P1)")
    if open_c["launches"] != expected or mfc.takes_fused(CAV_BATCH):
        raise AssertionError(f"cavity batched launches {open_c['launches']}, expected {expected}")
    carry_c = open_c["carry"]
    u_c = torch.zeros((CAV_BATCH, stc.n_act), dtype=stc.dtype, device=dev)
    stc.step(carry_c, u_c)
    torch.cuda.synchronize()
    profile_steps(fc, f"phase 20 (B={CAV_BATCH})", steps=3, step=lambda: stc.step(carry_c, u_c),
                  what="Stepper.step")
    del carry_c
    graphs[f"cavity multifrontal B={CAV_BATCH} open"] = phase_graph_rollout(
        stc, open_c["carry"], "multifrontal", "phase 20g")
    s_launches = [s_launches[0] + open_c["launches"][5], s_launches[1] + open_c["launches"][6]]
    spmm[CAV_BATCH] = phase_spmm(stc, "phase 20s", CAV_BATCH)
    k2_wide[CAV_BATCH] = phase_k2_wide(mfc, CAV_BATCH, "phase 20")
    p1[CAV_BATCH] = phase_p1(mfc, CAV_BATCH, 1 + refine_c, "phase 20")
    k1_cav = phase_kernel(fc.space, fc.geom, dev, widths=(CAV_BATCH,), tag="phase 20")

    # ── phase 21: where the cavity step goes; the cylinder's with F and without
    # (the eager Stepper.step: a graph keeps the route it was captured with)
    def eager_step(f):
        zero = torch.zeros(f.stepper.n_act, dtype=f.stepper.dtype, device=dev)
        return lambda: f.stepper.step(f._carry, zero)

    for f, name in ((fc, "cavity"), (fs2, "cylinder")):
        profile_steps(f, f"phase 21 ({name}, F)", step=eager_step(f), what="Stepper.step")
    fused_max_rows, mf_module.FUSED_MAX_ROWS = mf_module.FUSED_MAX_ROWS, 0
    try:  # the same steps through the per-stage sweep
        for f, name in ((fc, "cavity"), (fs2, "cylinder")):
            profile_steps(f, f"phase 21 ({name}, per-stage sweep)", step=eager_step(f),
                          what="Stepper.step")
    finally:
        mf_module.FUSED_MAX_ROWS = fused_max_rows

    # ── phase 44: the cavity's closed loop on phase 17's Stepper (no new
    # factorization): the committed LQG, 4000 steps open and closed
    cav_fb = cavity_feedback_phase(fc, stc, counters)

    # ── phase 22: the compiled entry points' graphs against eager, in sum ──
    graph_summary(graphs, "phase 22", card)

    # ── phases 23-33: the lid cavity and the pinball, on a card holding
    # nothing else (phase 32 measures what the dense factorization takes)
    n_cyl, n_cav = mf.n, mfc.n
    u0_cyl, p0_cyl = fs.fields.U0, fs.fields.P0  # phase 3's host base flow, for phase 34
    del fs, fs2, st2, mf, fc, stc, mfc, mfp["st"], cav["st"], stp, f
    for r in (open_mf, open_c):
        del r["carry"], r["y_last"]
    del r
    free_card()
    s_new, new_rows, pin_fb = new_flows(counters, card, child)
    s_launches = [s_launches[0] + s_new[0], s_launches[1] + s_new[1]]

    # ── phases 34-36: the analysis path on a card holding nothing else ──────
    ops = analysis(u0_cyl, p0_cyl, card)
    free_card()

    # ── phases 37-39: synthesis and the population search on its operators ──
    synthesis(ops, u0_cyl, p0_cyl, counters, card, factors)

    # ── phase 40: checkpoints and the restart at BDF2, on a card holding
    # nothing of the earlier phases; phase 42: the factor cache on it
    free_card()
    cached = restart_phase(u0_cyl, p0_cyl, counters, card, factors)

    # ── phase 41: the Krylov backends, on a card holding nothing else ──────
    krylov = krylov_phase(u0_cyl, p0_cyl, host, counters, card)
    s_launches = [s_launches[0] + krylov["s"], s_launches[1] + krylov["r"]]

    # ── phase 43: multi-GPU through torch.distributed, on a card holding
    # nothing else (worlds of 4 gloo ranks and of 1 NCCL rank on it)
    free_card()
    shard = sharded_phase(u0_cyl, p0_cyl, host, card, factors)
    s_launches = [s_launches[0] + shard["batch"][3], s_launches[1] + shard["batch"][4]]

    # ── phase 46: the half-million-dof cylinder, on a card holding nothing
    # else, its factor streamed from the host build that ran beside phases
    # 1-43
    free_card()
    huge = big_cylinder_phase(counters, card, child)

    src = "flowcontrol_tpu_torch/csrc/"
    f_launches = (mfp["launches"][4] + cav["launches"][4] + cav_fb["launches"][4] + cached["f"]
                  + huge["launches"][4])
    k2_cyl_launches = open_mf["launches"][1] + closed_mf["launches"][1]
    k2_launches = k2_cyl_launches + open_c["launches"][1]
    p1_cyl_launches = open_mf["launches"][2] + closed_mf["launches"][2]
    probe_src = "tools/pallas_gather_probe.py"
    log(f"chip_smoke: whole run {time.perf_counter() - t_run:.1f} s wall")
    print(json.dumps({"kernels": [
        kernel_row("K1 nl_convection", src + "nl_convection.cu",
            "flowcontrol_tpu/ops/pallas_nl.py:136",
            k1_launches + krylov["k1"] + shard["B1"][0] + cav_fb["launches"][0]
            + pin_fb["launches"][0], k1, None, phase43_launches=shard["B1"][0],
            phase44_launches=cav_fb["launches"][0], phase45_launches=pin_fb["launches"][0]),
        kernel_row(f"K1 nl_convection B={BATCH} cylinder", src + "nl_convection.cu",
            "flowcontrol_tpu/ops/pallas_nl.py:136", k1_batched_launches + shard["batch"][0],
            dict(max_abs_err=k1["max_abs_err"], **k1["widths"][BATCH]), None,
            phase43_launches=shard["batch"][0]),
        kernel_row(f"K1 nl_convection B={CAV_BATCH} cavity", src + "nl_convection.cu",
            "flowcontrol_tpu/ops/pallas_nl.py:136", open_c["launches"][0],
            dict(max_abs_err=k1_cav["max_abs_err"], **k1_cav["widths"][CAV_BATCH]), None),
        kernel_row("K2 stack_matvec", src + "mf_sweep.cu",
            "flowcontrol_tpu/ops/pallas_mf_matvec.py:79", k2_launches + shard["B1"][1], k2_narrow,
            k2_narrow["library_ms"], phase43_launches=shard["B1"][1]),
        kernel_row(f"K2 stack_matvec B={BATCH} cylinder", src + "mf_sweep.cu",
            "flowcontrol_tpu/ops/pallas_mf_matvec.py:79", k2_cyl_launches + shard["batch"][1],
            k2_wide[BATCH], k2_wide[BATCH]["library_ms"], phase43_launches=shard["batch"][1]),
        kernel_row(f"K2 stack_matvec B={CAV_BATCH} cavity", src + "mf_sweep.cu",
            "flowcontrol_tpu/ops/pallas_mf_matvec.py:79", open_c["launches"][1],
            k2_wide[CAV_BATCH], k2_wide[CAV_BATCH]["library_ms"]),
        kernel_row("K3 block_lu_solve_fused B=1", src + "block_trisolve.cu",
            "flowcontrol_tpu/ops/pallas_trisolve.py:127", blk["launches"][3], k3[1],
            k3[1]["library_ms"]),
        kernel_row(f"K3 block_lu_solve_fused B={BATCH}", src + "block_trisolve.cu",
            "flowcontrol_tpu/ops/pallas_trisolve.py:127", k3_batched_launches, k3[BATCH],
            k3[BATCH]["library_ms"]),
        # P1's rows: all its launches of one solve; library_ms is
        # index_select's time for the gather form (no call computes the
        # inbox form); beside them the inbox launches against the earlier
        # per-segment kernel, the gather form against torch's int64 index,
        # and the sweep's device time outside K2 per solve now and before
        kernel_row(f"P1 sweep_gather B={BATCH} cylinder", src + "mf_sweep.cu", probe_src + ":50",
            p1_cyl_launches + shard["B1"][2] + shard["batch"][2], p1[BATCH],
            p1[BATCH]["library_ms"], **{k: p1[BATCH][k] for k in P1_EXTRA},
            phase43_launches=shard["B1"][2] + shard["batch"][2]),
        kernel_row(f"P1 sweep_gather B={CAV_BATCH} cavity", src + "mf_sweep.cu", probe_src + ":50",
            open_c["launches"][2], p1[CAV_BATCH], p1[CAV_BATCH]["library_ms"],
            **{k: p1[CAV_BATCH][k] for k in P1_EXTRA}),
        kernel_row(f"F multifrontal_solve_fused cylinder n={n_cyl}", src + "mf_fused.cu",
            "flowcontrol_tpu/solvers/multifrontal.py:1202", mfp["launches"][4] + cached["f"], f_cyl,
            None,
            sweep_ms=f_cyl["sweep_ms"]),
        kernel_row(f"F multifrontal_solve_fused cavity n={n_cav}", src + "mf_fused.cu",
            "flowcontrol_tpu/solvers/multifrontal.py:1202",
            cav["launches"][4] + cav_fb["launches"][4], f_cav, None, sweep_ms=f_cav["sweep_ms"],
            phase44_launches=cav_fb["launches"][4]),
        kernel_row(f"F multifrontal_solve_fused cylinder n={huge['n']}", src + "mf_fused.cu",
            "flowcontrol_tpu/solvers/multifrontal.py:1202", huge["launches"][4], huge["f"], None,
            sweep_ms=huge["f"]["sweep_ms"], phase46_launches=huge["launches"][4]),
        kernel_row(f"K1 nl_convection cylinder n={huge['n']}", src + "nl_convection.cu",
            "flowcontrol_tpu/ops/pallas_nl.py:136", huge["launches"][0], huge["k1"], None,
            phase46_launches=huge["launches"][0]),
        # P2-P4 run on the main path as device functions inside every F
        # launch; their times are their own kernels' at the probe's shapes
        kernel_row("P2 take_along_axis_lanes", src + "mf_fused.cu", probe_src + ":65", f_launches,
            probes["P2"], probes["P2"]["library_ms"], launched_inside="F"),
        kernel_row("P3 dynamic_slice_smem_offset", src + "mf_fused.cu", probe_src + ":77", f_launches,
            probes["P3"], probes["P3"]["library_ms"], launched_inside="F"),
        kernel_row("P4 dynamic_offset_accum_store", src + "mf_fused.cu", probe_src + ":89",
            f_launches, probes["P4"], probes["P4"]["library_ms"], launched_inside="F"),
        # S replaces no Pallas kernel: it stands for the JAX stepper's XLA
        # operator applies. Its rows: the mass at B = BATCH (f32, with the
        # f64 operator's numbers beside it) and the fused residual at
        # B = BATCH, each with the cavity's at B = CAV_BATCH
        kernel_row(f"S csr_matmul B={BATCH} mass f32", src + "csr_spmm.cu",
            "flowcontrol_tpu/core/stepper.py:885", s_launches[0], spmm[BATCH]["f32"],
            spmm[BATCH]["f32"]["library_ms"], rowwise_ms=spmm[BATCH]["f32"]["rowwise_ms"],
            phase43_launches=shard["batch"][3],
            **{f"f64_{k}": spmm[BATCH]["f64"][k] for k in (
                "max_abs_err", "ms", "rowwise_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by")},
            **{f"cavity_B{CAV_BATCH}_{k}": spmm[CAV_BATCH]["f32"][k] for k in (
                "ms", "rowwise_ms", "plain_ms", "library_ms", "bound_ms")}),
        kernel_row(f"S csr_residual B={BATCH}", src + "csr_spmm.cu",
            "flowcontrol_tpu/core/stepper.py:885", s_launches[1], spmm[BATCH]["residual"], None,
            phase43_launches=shard["batch"][4],
            composition_ms=spmm[BATCH]["residual"]["composition_ms"],
            composition_rowwise_ms=spmm[BATCH]["residual"]["composition_rowwise_ms"],
            **{f"cavity_B{CAV_BATCH}_{k}": spmm[CAV_BATCH]["residual"][k] for k in (
                "ms", "composition_ms", "composition_rowwise_ms", "plain_ms", "bound_ms")}),
        *new_rows,
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--prebuild"]:
        sys.exit(prebuild_factors(Path(sys.argv[2])))
    sys.exit(main())
