"""Plan-based sub-grid (de)gridding, the create/exec pattern
(examples/subgrid_gridding.py on the port).

The analogue of the reference's plan-template example
(examples/sdp_function_example_a.cpp: create -> exec -> free) for the
w-towers gridder: build a plan once, run grid and degrid against it
(complex64 on the card: the all-layer kernels K16/K17 over one task),
check the adjoint identity.

    python -m ska_sdp_func_torch.examples.subgrid_gridding

The oracle: <y, A x> == <A^T y, x> within ``ADJOINT_TOL``, relative.
"""

import sys

import numpy as np
import torch

from ..grid_data import GridderWtowerUVW
from ..utility.constants import C_0
from . import _device, _finish, _oracle

ADJOINT_TOL = 1e-5


def run(device=None, subgrid_size: int = 64, num_rows: int = 256,
        num_chan: int = 4, seed: int = 0) -> dict:
    """The demo on ``device``; returns both sides of the adjoint
    identity, their relative difference, the w-plane counters and the
    oracle's check."""
    dev = _device(device)
    rng = np.random.default_rng(seed)
    theta, w_step = 0.002, 100.0
    freq0, dfreq = C_0, C_0 / (100 * num_chan)

    # Plan: oversampled PSWF uv/w kernels + w_pattern, computed once.
    plan = GridderWtowerUVW(subgrid_size, subgrid_size, theta, w_step,
                            0.0, 0.0, support=8, oversampling=16384,
                            w_support=4, w_oversampling=16384)

    uvw = rng.uniform(-1, 1, (num_rows, 3)).astype(np.float32)
    uvw[:, :2] *= 0.4 * subgrid_size / 2 / theta
    uvw[:, 2] *= 1.5 * w_step
    uvw_d = torch.as_tensor(uvw, device=dev)
    start = torch.zeros((num_rows,), dtype=torch.int32, device=dev)
    end = torch.full((num_rows,), num_chan, dtype=torch.int32, device=dev)

    # Forward: image -> visibilities.
    image = torch.as_tensor(
        (rng.standard_normal((subgrid_size, subgrid_size))
         + 1j * rng.standard_normal((subgrid_size, subgrid_size))
         ).astype(np.complex64), device=dev)
    vis = plan.degrid_subgrid(image, (0, 0, 0), num_chan, freq0, dfreq,
                              uvw_d, start, end, device=dev)

    # Adjoint: visibilities -> image.
    y = torch.as_tensor((rng.standard_normal((num_rows, num_chan))
                         + 1j * rng.standard_normal((num_rows, num_chan))
                         ).astype(np.complex64), device=dev)
    img_adj = plan.grid_subgrid(
        y, uvw_d, start, end, num_chan, freq0, dfreq,
        torch.zeros((subgrid_size, subgrid_size), dtype=torch.complex64,
                    device=dev), (0, 0, 0), device=dev)

    # <y, A x> == <A^T y, x>, summed on the host in complex128.
    def host(x):
        return x.cpu().numpy().astype(np.complex128)

    lhs = np.vdot(host(y), host(vis))
    rhs = np.vdot(host(img_adj), host(image))
    rel = abs(lhs - rhs) / abs(lhs)
    return dict(lhs=complex(lhs), rhs=complex(rhs), rel=float(rel),
                w_planes=(plan.num_w_planes(0), plan.num_w_planes(1)),
                oracle=_oracle(("adjointness, rel", rel, ADJOINT_TOL)))


def main(device=None, **sizes) -> int:
    r = run(device, **sizes)
    print(f"adjointness: <y, Ax> = {r['lhs']:.6f}  <A^T y, x> = "
          f"{r['rhs']:.6f}  rel = {r['rel']:.2e}")
    print("w-planes processed (degrid, grid): "
          f"{r['w_planes'][0]}, {r['w_planes'][1]}")
    return _finish(r)


if __name__ == "__main__":
    sys.exit(main())
