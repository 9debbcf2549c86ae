"""Dense multi-channel histogram K2: the CUDA kernel's wrapper and its plain
PyTorch version (counterpart of lightgbm_tpu/ops/pallas_hist.py
``hist_pallas_channels`` / ``_hist_kernel`` and its single-leaf wrappers
``hist_pallas_fm`` / ``hist_pallas``).

``out[f, b, c] = sum_r gh[r, c] * (bins[f, r] == b)`` in f32, for bins
[F, N] u8 and gh [N, C] f32 with C a multiple of 32 (the kernel's work
item; the Pallas kernel's lane group is 128); rows whose bin is >= B add
nothing.  The serial grower (``core/grower.py build_grow_fn``) calls its
single-leaf form ``hist_channels_fm`` at C = 32 for every leaf histogram
of columns of up to 256 bins, as the JAX package's ``hist_pallas_fm``
serves its serial grower.

On Hopper (``csrc/hist_channels.cu``) a block takes work items of (row
chunk, 32 channels, 4 features) and keeps the item's [4][B][32] f32
histogram in shared memory, where every cell has one owning thread that
adds with plain loads and stores (no atomics); rows are staged in tiles
and added four at a time, rows of one bin summed in registers first.  Each
item writes its chunk's slice of a workspace, and a second launch sums the
chunks in order.  The order of every sum is fixed by the inputs and the
launch geometry (``geometry``), so two launches on the same inputs are
bit-equal; sums agree with ``hist_channels_plain`` to f32 rounding.

``hist_channels`` takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import math

import torch

from ..obs.core import phase
from . import build as _build

GROUP = 32                   # C must be a multiple of this
_ITEM_FEATURES = 4           # features of a work item (kFeat in the source)
_ITEM_CHANNELS = 32          # channels of a work item (kCh)
_MIN_CHUNK_ROWS = 4096
_SMEM_PER_SM = 228 * 1024    # shared memory of an H100 SM
_THREADS_PER_SM = 2048       # ... and its threads; a block has 1,024


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


def geometry(sms: int, smem: int, F: int, N: int, C: int):
    """The kernel's launch: (row chunks, blocks).  The work items are
    (row chunk, 32 channels, 4 features); the blocks are as many as the
    card holds at once (``sms`` SMs, ``smem`` bytes of shared memory and
    1,024 threads a block), or fewer when there are fewer items.  The
    chunks are the fewest that make the items a whole number of rounds
    over those blocks, and no more than one per ``_MIN_CHUNK_ROWS``
    rows."""
    per_sm = max(1, min(_THREADS_PER_SM // 1024,
                        _SMEM_PER_SM // (smem + 1024)))
    resident = sms * per_sm
    combos = -(-F // _ITEM_FEATURES) * (C // _ITEM_CHANNELS)
    chunks = resident // math.gcd(resident, max(combos, 1))
    chunks = max(1, min(chunks, -(-N // _MIN_CHUNK_ROWS)))
    return chunks, max(1, min(chunks * combos, resident))


def hist_channels_cost(N: int, F: int, B: int, C: int):
    """(operations, bytes) of one K2 launch: bytes, the ``F*N`` bin read,
    the [N, C] f32 values and the [F, B, C] f32 output; operations, one
    add per (feature, row, channel) (every bin below B).  ``chip_smoke.py``
    and profile mode (``obs/profile.py``) state K2's bound from it."""
    return float(F * N * C), float(F * N + 4 * N * C + 4 * F * B * C)


def hist_channels_call_cost(bins_fm, gh, B: int):
    """``hist_channels_cost`` of a call with ``hist_channels``'s
    arguments."""
    F, N = bins_fm.shape
    return hist_channels_cost(N, F, B, gh.shape[1])


def hist_channels(bins_fm, gh, B: int):
    """K2 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  bins_fm: uint8 [F, N]; gh: f32 [N, C],
    C a multiple of 32; B <= 256.  Returns f32 [F, B, C]."""
    if bins_fm.device.type == "cpu":
        # the range a CPU profiler window holds against K2's cost (on the
        # card K2 is found by its CUDA symbol)
        with phase("hist_channels"):
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
    chunks, grid = geometry(
        torch.cuda.get_device_properties(dev).multi_processor_count,
        lib.lgbm_hist_channels_smem_bytes(B), F, N, C)
    # every chunk's slice is written whole (zeros for an empty chunk)
    ws = torch.empty(chunks * F * B * C, dtype=torch.float32, device=dev)
    out = torch.empty((F, B, C), dtype=torch.float32, device=dev)
    _build.check_launch("hist_channels", lib.lgbm_hist_channels(
        bins_fm.data_ptr(), gh.data_ptr(), F, N, B, C, chunks, grid,
        ws.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream))
    hist_channels.launches += 1
    return out


hist_channels.launches = 0


def hist_channels_fm(bins_fm, g, h, mask, B: int):
    """Single-leaf histogram from feature-major bins: f32 [F, B, 3] of
    (sum g*mask, sum h*mask, sum mask) through K2 at one channel group of
    32, three of them used (``hist_pallas_fm``, which pads to 128)."""
    N = bins_fm.shape[1]
    gh = torch.zeros((N, GROUP), dtype=torch.float32, device=bins_fm.device)
    gh[:, 0] = g * mask
    gh[:, 1] = h * mask
    gh[:, 2] = mask
    from ..obs import profile
    kern = profile.wrap("hist_channels", hist_channels,
                        cost=hist_channels_call_cost)
    return kern(bins_fm, gh, B)[..., :3]
