"""flowcontrol_tpu_torch — the PyTorch/CUDA port of flowcontrol_tpu.

Incompressible Navier-Stokes in perturbation form around a steady base flow,
Taylor-Hood P2/P1 FEM on unstructured triangle meshes, BDF1/BDF2/CN stepping
and Newton/Picard base flows, with the time-stepping hot loop on one
explicit torch device (an NVIDIA H100 in production, the CPU in the tests).

The package mirrors the layout of ``flowcontrol_tpu`` (core/, fem/, mesh/,
models/, ops/, solvers/) so each module's counterpart sits at the same path.
It imports torch, numpy and scipy, and never JAX or ``flowcontrol_tpu``:
``flowcontrol_tpu`` stays the numerical reference that the tests compare
against. Import the entry points from their modules, e.g.
``from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver``.
"""

__version__ = "0.1.0"
