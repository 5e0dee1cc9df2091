"""Build / product overlap probe (the fused kernels' A/B kernel).

Counterpart of the Pallas kernel of experiments/exp_overlap.py
(``measure_one.run``, body ``kernel``). Over slots of plan words ``pa``,
``pb`` (int32) in blocks of ``block``, each block sums over its chunks of
``sub`` slots ``acc += U @ V`` (``U [128, sub]``, ``V [sub, 128]``, f32
products), where per slot a tap build shaped like the fused gridder's
(three Clenshaw evaluations of the fit ``coeffs [degree + 1, 8]`` and a
one-hot placement) makes its column of U and row of V. :data:`VARIANTS`:

- ``dot``: no build, ``U[m, p] = pa[p] 1e-9``, ``V[p, n] = pb[p] 1e-9``;
- ``vpu``: the build, consumed without a product: ``acc += U[:, c0]
  V[c0, :]`` for the first slot ``c0`` of each chunk;
- ``both``: the build feeds the product;
- ``both2``: the same sums, the next tile's build issued after this tile's
  product (software pipelining).

:func:`overlap` returns the TPU kernel's output, the last block's ``acc
[128, 128]``, and each block's ``sum |acc|`` ``[num_blocks]``: that vector
shows that every block's work was done (the output alone depends on the
last block only).

On a CUDA tensor :func:`overlap` launches the kernel (``csrc/overlap.cu``:
one CTA an SM over the blocks, 64-slot stages (32 where ``block`` is no
multiple of 64), tensor-core products as three TF32 passes of ``wgmma``;
``dot``, ``vpu`` and ``both`` with a builder warpgroup filling a ring
beside two consumer warpgroups, ``both2`` with each warpgroup building
the next stage while its products run) or raises; on a CPU tensor it runs
:func:`overlap_reference` (true f32 products). It counts its kernel
launches in ``.launches``.
"""

import torch

from ..utility.errors import SdpInvalidArgumentError, SdpMemLocationError, \
    SdpShapeError
from .packed_tap import _check, _full_f32_matmul

VARIANTS = ("dot", "vpu", "both", "both2")
SUPPORT = 8
LANES = 128
_TILE = 32            # the smallest stage of csrc/overlap.cu
_MAX_COEFFS = 16
_REF_BLOCKS = 256     # blocks per step of the plain version


def clenshaw(x, c):
    """Taps ``[S, n]`` of the fit ``c [degree + 1, S]`` at ``x [n]``, in the
    experiment's operation order."""
    b1 = torch.zeros((c.shape[1], x.shape[0]), dtype=torch.float32,
                     device=x.device)
    b2 = torch.zeros_like(b1)
    for k in range(c.shape[0] - 1, 0, -1):
        b1, b2 = c[k][:, None] + 2.0 * x * b1 - b2, b1
    return c[0][:, None] + x * b1 - b2


def build(pa, pb, c):
    """``(U [128, n], V [n, 128])`` of slots ``pa``, ``pb`` [n]: the
    experiment's ``build``."""
    n = pa.shape[0]
    dev = pa.device
    uk = clenshaw(pa.to(torch.float32) * 1e-7 - 0.5, c)
    vk = clenshaw(pb.to(torch.float32) * 1e-7 - 0.5, c)
    wk = clenshaw((pa ^ pb).to(torch.float32) * 1e-7 - 0.5, c)
    s = torch.arange(SUPPORT, device=dev)
    vb = torch.zeros((n, LANES), dtype=torch.float32, device=dev)
    vb.scatter_(1, ((pa & 120).to(torch.int64)[:, None] + s[None, :]), vk.T)
    ub = torch.zeros((16, n), dtype=torch.float32, device=dev)
    ub.scatter_(0, (pb & 7).to(torch.int64)[None, :] + s[:, None], uk)
    u_all = torch.cat([ub * wk[j % 4] for j in range(8)])
    return u_all, vb


def _operands(variant, pa, pb, c):
    if variant == "dot":
        n = pa.shape[0]
        return ((pa.to(torch.float32) * 1e-9)[None, :].expand(LANES, n),
                (pb.to(torch.float32) * 1e-9)[:, None].expand(n, LANES))
    return build(pa, pb, c)


def overlap_reference(variant: str, pa, pb, coeffs, block: int, sub: int):
    """Plain PyTorch version of :func:`overlap`."""
    nblk = pa.shape[0] // block
    out, sums = None, []
    for lo in range(0, nblk, _REF_BLOCKS):
        hi = min(nblk, lo + _REF_BLOCKS)
        sl = slice(lo * block, hi * block)
        u, v = _operands(variant, pa[sl], pb[sl], coeffs)
        n = hi - lo
        u = u.reshape(LANES, n, block).permute(1, 0, 2)       # [n, 128, B]
        v = v.reshape(n, block, LANES)
        if variant == "vpu":
            acc = torch.zeros((n, LANES, LANES), dtype=torch.float32,
                              device=pa.device)
            for c0 in range(0, block, sub):
                acc = acc + u[:, :, c0, None] * v[:, c0, None, :]
        else:
            with _full_f32_matmul():
                acc = torch.bmm(u, v)
        sums.append(acc.abs().sum((1, 2)))
        out = acc[-1]
    return out, torch.cat(sums)


def overlap(variant: str, pa, pb, coeffs, block: int = 1024,
            sub: int = 512):
    """``(acc of the last block [128, 128], sum |acc| of each block
    [num_blocks])`` f32 of ``variant`` over ``pa``, ``pb`` [num_blocks *
    block] int32 (words in [0, 2^24)), ``coeffs`` [degree + 1, 8] f32;
    ``block`` a multiple of ``sub``, ``sub`` of 32."""
    if variant not in VARIANTS:
        raise SdpInvalidArgumentError(f"unknown variant {variant!r}")
    if pa.ndim != 1:
        raise SdpShapeError("pa must be [total]")
    total = pa.shape[0]
    if sub < _TILE or sub % _TILE or block % sub or not total \
            or total % block:
        raise SdpInvalidArgumentError(
            f"total {total} must be a multiple of block={block}, block of "
            f"sub={sub}, sub of {_TILE}")
    dev = pa.device
    _check(dev, [("pa", pa), ("pb", pb)], torch.int32, (total,))
    if coeffs.ndim != 2 or coeffs.shape[1] != SUPPORT \
            or not 2 <= coeffs.shape[0] <= _MAX_COEFFS:
        raise SdpInvalidArgumentError(
            f"coeffs must be [degree + 1 <= {_MAX_COEFFS}, {SUPPORT}]")
    _check(dev, [("coeffs", coeffs)], torch.float32)
    if dev.type == "cpu":
        return overlap_reference(variant, pa, pb, coeffs, block, sub)
    if dev.type != "cuda":
        raise SdpMemLocationError(f"unsupported device {dev}")
    from . import _build

    lib = _build.load()
    nblk = total // block
    out = torch.empty((LANES, LANES), dtype=torch.float32, device=dev)
    sums = torch.empty(nblk, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.sdp_torch_overlap(
            VARIANTS.index(variant), pa.data_ptr(), pb.data_ptr(),
            coeffs.data_ptr(), coeffs.shape[0], block, sub, nblk,
            out.data_ptr(), sums.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "overlap")
    overlap.launches += 1
    return out, sums


overlap.launches = 0


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return {"overlap": overlap.launches}


def reset_launch_counts() -> None:
    overlap.launches = 0
