"""Utility layer (ref: src/utils/__init__.py).

``flowcontrol_tpu_torch.utils`` doubles as the legacy flat aggregator
namespace the reference calls ``flu`` (ref: src/utils/utils_flowsolver.py:
1-133), as ``flowcontrol_tpu/utils/__init__.py`` does: the most used names
of fem, io, linalg, lticontrol, optim and signal are reachable here, so
``import flowcontrol_tpu_torch.utils as flu`` works for reference-style code.

The names are resolved on first use (a module ``__getattr__``, PEP 562),
not imported with the package: every ``import
flowcontrol_tpu_torch.utils.<module>`` runs this file, and eager imports
would make a cycle (``core.controller`` -> ``utils.statespace`` -> here ->
``utils.linalg`` -> ``core.stepper``) and load torch-side modules for
callers that want one numpy helper.

Against the JAX package's aggregator: ``get_frequency_response_tpu`` is
here under the port's name, ``get_frequency_response_device``, beside
``eig_arnoldi_dense_device``; ``get_frequency_response_mpi`` is the sweep
with its ω split over the ranks of a ``torch.distributed`` group
(``get_frequency_response_sharded``).
"""

from __future__ import annotations

import importlib

_NAMES = {
    "fem": ("apply_fun", "get_subspace_dofs", "print0", "projectm", "summarize_timings"),
    "io": ("export_boundary_field", "export_complex_field", "export_dof_map",
           "export_field_vtk", "export_npz_to_mat", "export_sparse_matrix",
           "export_square_operators", "load_Hw", "plot_Hw", "save_Hw"),
    "linalg": ("dense_to_sparse", "eig_arnoldi_dense_device", "eigenproblem_slepc",
               "get_field_response", "get_frequency_response",
               "get_frequency_response_device", "get_frequency_response_mpi",
               "get_frequency_response_parallel", "get_frequency_response_sequential",
               "get_mat_vp_shift_invert",
               "get_mat_vp_slepc", "sparse_to_coo_triplets"),
    "optim": ("batch_evaluate", "parallel_function_wrapper", "compute_control_cost",
              "compute_signal_cost", "cummin", "fun_array", "sobol_sample",
              "write_optim_csv", "write_results"),
    "signal": ("MultisineGenerator", "plotsignal", "MyEncoder", "NoIndent",
               "compute_signal_frequency", "crest_factor", "multisine", "multisine_MP",
               "pad_upto", "sample_lco", "saturate"),
}


def _lticontrol_names() -> tuple:
    return tuple(importlib.import_module(f"{__name__}.lticontrol").__all__)


def _module_of(name: str) -> str | None:
    for module, names in _NAMES.items():
        if name in names:
            return module
    if name in _lticontrol_names():
        return "lticontrol"
    return None


def __getattr__(name: str):
    module = _module_of(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__() -> list:
    return sorted(set(globals()) | {n for ns in _NAMES.values() for n in ns}
                  | set(_lticontrol_names()))
