"""The per-stage multifrontal sweep's earlier dataflow, kept for the tests
as the reference the current sweep is held to bit for bit.

It pads b with a zero and gathers it through the int64 permutation, zeroes
the whole contribution buffer, subtracts each tabbed inbox segment with the
per-segment P1 (``ops/mf_matvec.gather_sum_sub``: its plain version on the
CPU, the per-segment kernel on CUDA), copies z over xe, gathers each
stage's boundary through the int64 ``bd`` and leaves through an int64
``ipos`` gather: the sweep as it ran before P1 took every gather. Not a
test module (no ``test_`` prefix): ``tests/test_torch_gather.py`` and
``tests/test_torch_cuda.py`` import it.
"""

import torch

from flowcontrol_tpu_torch.ops.mf_matvec import gather_sum_sub, stack_matvec


def multifrontal_solve_reference(mf, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b for b (..., n), through the earlier dataflow."""
    batch = b.shape[:-1]
    n = mf.n
    dtype = mf.dtype
    out_dtype = b.dtype if b.dtype in (torch.float32, torch.float64) else dtype
    rows = 1
    for d in batch:
        rows *= int(d)
    bb = b.reshape(rows, n).to(dtype)
    dev = bb.device
    total, n_stages = mf.total_slots, len(mf.stages)
    xs = -(-(total + 1) // 4) * 4
    x = torch.nn.functional.pad(bb, (0, 1))[
        :, torch.nn.functional.pad(mf.perm, (0, xs - total - 1), value=n)]
    buf = torch.zeros((rows, 1 + mf.total_contrib), dtype=dtype, device=dev)

    for si, st in enumerate(mf.stages):
        e, m, off = st.e, st.m, st.off
        ti = 0
        for (m0, m1, tabbed) in st.segs:
            if not tabbed:
                continue
            seg = x[:, off + m0 * e: off + m1 * e]
            gather_sum_sub(buf, st.inbox[ti], seg, out=seg)
            ti += 1
        xe = x[:, off: off + m * e].view(rows, m, e)
        z = stack_matvec(st.inv, xe)
        if si < n_stages - 1:  # the root's updates have no consumer
            c0 = 1 + st.c_off
            stack_matvec(st.fbi, z, out=buf[:, c0: c0 + m * st.b].view(rows, m, st.b))
        xe.copy_(z)

    for st in reversed(mf.stages):
        e, m, off = st.e, st.m, st.off
        xb = x[:, st.bd.reshape(-1)].view(rows, m, st.b)  # ancestor slots are final
        corr = stack_matvec(st.ginv, xb)
        x[:, off: off + m * e].sub_(corr.reshape(rows, m * e))

    return x[:, mf.ipos].reshape(batch + (n,)).to(out_dtype)
