"""Dense multi-channel histogram K2: the CUDA kernel's wrapper and its plain
PyTorch version (counterpart of lightgbm_tpu/ops/pallas_hist.py
``hist_pallas_channels`` / ``_hist_kernel`` and its single-leaf wrappers
``hist_pallas_fm`` / ``hist_pallas``).

``out[f, b, c] = sum_r gh[r, c] * (bins[f, r] == b)`` in f32, for bins
[F, N] u8 and gh [N, C] f32 with C a multiple of 128; rows whose bin is
>= B add nothing.  Nothing on the training path calls it, as in the JAX
package.

On Hopper (``csrc/hist_channels.cu``) the function is bound by bytes (the
4*N*C byte read of gh dominates); the kernel keeps one [B][128] f32
histogram per block in shared memory, one warp per row adding its 128
channels with conflict-free shared atomics, and reduces the block
partials in a second launch.  Its adds run in an order that changes from
run to run: sums agree with ``hist_channels_plain`` to f32 rounding.

``hist_channels`` takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import build as _build

GROUP = 128                  # channels of one kernel block
_ROWS_PER_CHUNK = 4096


def hist_channels_plain(bins_fm, gh, B: int):
    """Plain PyTorch K2: one ``index_add_`` per feature into a histogram
    with a spare row that takes the bins >= B."""
    F, N = bins_fm.shape
    C = gh.shape[1]
    out = torch.zeros((F, B + 1, C), dtype=torch.float32, device=gh.device)
    ghf = gh.float()
    for f in range(F):
        out[f].index_add_(0, bins_fm[f].long().clamp(max=B), ghf)
    return out[:, :B].contiguous()


def _groups(dev, F: int, CG: int, smem: int, chunks: int) -> int:
    """Blocks per (feature, channel group): one round over the SMs at the
    occupancy the shared histogram allows, at most one per row chunk."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = max(1, (227 * 1024) // max(smem, 1))
    return max(1, min(chunks, sms * per_sm // max(F * CG, 1)))


def hist_channels(bins_fm, gh, B: int):
    """K2 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  bins_fm: uint8 [F, N]; gh: f32 [N, C],
    C a multiple of 128; B <= 256.  Returns f32 [F, B, C]."""
    if bins_fm.device.type == "cpu":
        return hist_channels_plain(bins_fm, gh, B)
    if not bins_fm.is_cuda:
        raise ValueError(f"hist_channels: no kernel for device "
                         f"{bins_fm.device}")
    F, N = bins_fm.shape
    dev = bins_fm.device
    if bins_fm.dtype != torch.uint8 or not bins_fm.is_contiguous():
        raise TypeError("hist_channels: bins_fm must be contiguous uint8")
    if (gh.dtype != torch.float32 or gh.dim() != 2 or gh.shape[0] != N
            or gh.device != dev or not gh.is_contiguous()):
        raise ValueError(f"hist_channels: gh must be contiguous f32 [{N}, C] "
                         f"on {dev}")
    C = gh.shape[1]
    if C % GROUP or gh.data_ptr() % 16:
        raise ValueError(f"hist_channels: C must be a multiple of {GROUP} "
                         f"and gh 16-byte aligned, got C={C}")
    if not (1 <= B <= 256):
        raise ValueError(f"hist_channels: B must be in [1, 256], got {B}")
    lib = _build.load()
    smem = lib.lgbm_hist_channels_smem_bytes(B)
    chunks = -(-N // _ROWS_PER_CHUNK)
    groups = _groups(dev, F, C // GROUP, smem, chunks) if N else 1
    ws = torch.empty(groups * F * B * C if N else 0, dtype=torch.float32,
                     device=dev)
    out = torch.empty((F, B, C), dtype=torch.float32, device=dev)
    _build.check_launch("hist_channels", lib.lgbm_hist_channels(
        bins_fm.data_ptr(), gh.data_ptr(), F, N, B, C, groups,
        _ROWS_PER_CHUNK, ws.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream))
    hist_channels.launches += 1
    return out


hist_channels.launches = 0


def hist_channels_fm(bins_fm, g, h, mask, B: int):
    """Single-leaf histogram from feature-major bins: f32 [F, B, 3] of
    (sum g*mask, sum h*mask, sum mask) through K2's first channel group
    (``hist_pallas_fm``)."""
    N = bins_fm.shape[1]
    gh = torch.zeros((N, GROUP), dtype=torch.float32, device=bins_fm.device)
    gh[:, 0] = g * mask
    gh[:, 1] = h * mask
    gh[:, 2] = mask
    return hist_channels(bins_fm, gh, B)[..., :3]
