"""Convert exported operator .npz files to .mat for Matlab workflows.

    python -m flowcontrol_tpu_torch.examples.convert_npz_to_mat A.npz [E.npz ...]

The port's copy of ``examples/convert_npz_to_mat.py``, which needs only
numpy and scipy (ref: src/examples/operators/convert_npz_to_mat.py): a
scipy sparse ``.npz`` becomes 1-based (rows, cols, vals, shape) triplets,
any other ``.npz`` its arrays as they are.
"""

import sys
from pathlib import Path

import numpy as np
import scipy.io as sio
import scipy.sparse as sp


def convert(npz_path, mat_path=None):
    npz_path = Path(npz_path)
    mat_path = Path(mat_path) if mat_path else npz_path.with_suffix(".mat")
    try:
        mat = sp.load_npz(npz_path)
        coo = mat.tocoo()
        sio.savemat(mat_path, {
            "rows": coo.row + 1, "cols": coo.col + 1, "vals": coo.data,
            "shape": np.asarray(mat.shape),
        })
    except Exception:
        data = dict(np.load(npz_path))
        sio.savemat(mat_path, data)
    print(f"{npz_path} -> {mat_path}")


if __name__ == "__main__":
    for p in sys.argv[1:]:
        convert(p)
