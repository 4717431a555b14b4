"""Write the four default meshes in the port's XDMF format (ref:
mesh_generation/generate_all.py:14-24).

    python -m flowcontrol_tpu_torch.mesh.generate_all [out_dir]

The port's copy of ``flowcontrol_tpu/mesh/generate_all.py``: each mesh as
``<out_dir>/<flow>.xdmf`` beside its ``.npy`` arrays (``mesh/io.py``), read
back by ``make_default(meshpath=...)``. The models generate the same meshes
in memory when given no mesh, so nothing needs these files.
"""

import sys
from pathlib import Path


def main(out_dir="generated_meshes"):
    from flowcontrol_tpu_torch.mesh.generation import (
        cavity_mesh, cylinder_mesh, lidcavity_mesh, mesh_quality, pinball_mesh,
    )
    from flowcontrol_tpu_torch.mesh.io import write_xdmf_mesh

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for name, gen in [
        ("cylinder", lambda: cylinder_mesh(yinf=10.0)),
        ("cavity", cavity_mesh),
        ("lidcavity", lambda: lidcavity_mesh(64, diagonal="crossed")),
        ("pinball", pinball_mesh),
    ]:
        mesh = gen()
        write_xdmf_mesh(out / f"{name}.xdmf", mesh)
        print(name, mesh_quality(mesh))


if __name__ == "__main__":
    main(*sys.argv[1:])
