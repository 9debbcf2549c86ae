"""Tree learners across ranks (counterpart of lightgbm_tpu/parallel/mesh.py;
reference: src/treelearner/{data,feature,voting}_parallel_tree_learner.cpp,
network.cpp).

The JAX package runs one process over a device mesh, its growers under
``shard_map`` with ``psum``.  The port runs one process a rank, and the
collectives are ``torch.distributed``'s: ``_psum`` (all_reduce SUM),
``_all_gather`` and ``_pmax`` (all_reduce MAX), each counted in
``collective_counts`` (and in telemetry).  Every rank holds the whole
``Dataset``, as the JAX process holds all rows; under ``data`` and
``voting`` it grows on its contiguous block of the padded rows, the block
``P("data")`` gives device ``rank`` (``shard_rows``).  All three learners
reuse the serial growers (``core/grower.py``, ``core/wave_grower.py``);
only the histogram reduction and the split search differ:

- data parallel: local histograms (K2 on the serial grower, K1 on the
  wave grower) summed across ranks, then the serial algorithm on every
  rank (reference: ReduceScatter + SyncUpGlobalBestSplit);
- voting parallel: each rank votes its ``top_k`` features by local
  |sum g|, and only voted columns are summed (PV-Tree); siblings are
  histogrammed, not subtracted;
- feature parallel: every rank histograms and scans its block of
  columns over all rows, and an all-gather with an argmax picks the
  winner.

At world size 1 the same code runs with the collectives as identities.
Trees come out identical on every rank; the engine grower gathers the
rows' leaf ids after each tree, so every rank's scores are the whole
data set's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import obs
from ..core import splitter
from ..core.grower import build_grow_fn, phys_hist_fn
from ..core.meta import DeviceMeta
from ..utils import log

AXIS = "data"

# the recorded topology (reference: network.cpp Network::Init state);
# Booster.set_network and init_distributed write it
NETWORK = {"machines": "", "num_machines": 1, "rank": 0,
           "local_listen_port": 12400}

# calls and payload bytes (the sending rank's) of each collective kind,
# process-wide, counted where the group holds more than one rank
collective_counts = {k: {"calls": 0, "bytes": 0}
                     for k in ("psum", "all_gather", "pmax")}


class Mesh(NamedTuple):
    """The ranks one learner spans: ``size`` ranks, this one ``rank``;
    ``group`` is the process group of its device collectives (None: the
    default gloo group) on ``device``."""
    size: int
    rank: int
    group: object
    device: torch.device


def build_mesh(tpu_mesh_shape: str = "", device="cpu") -> Mesh:
    """The world of the process group (1 rank without one).
    ``tpu_mesh_shape`` "data:N" must ask for at least the world's ranks:
    one process is one rank here, so a mesh smaller than the world has no
    meaning (the JAX package caps its device list at N instead)."""
    from . import distributed
    world, rank = distributed.world_size(), distributed.rank()
    for part in (tpu_mesh_shape or "").split(","):
        name, _, cnt = part.partition(":")
        if name.strip() != AXIS or not cnt:
            continue
        try:
            want = int(cnt)
        except ValueError:
            log.fatal(f"tpu_mesh_shape count is not an integer: "
                      f"{tpu_mesh_shape!r}")
        if want < 1:
            log.fatal(f"tpu_mesh_shape needs at least 1 device on "
                      f"'{AXIS}', got {want}")
        if want < world:
            log.fatal(f"tpu_mesh_shape={tpu_mesh_shape!r} asks for fewer "
                      f"ranks than the {world} of the process group; the "
                      "port runs one process a rank")
    device = torch.device(device)
    return Mesh(world, rank, distributed.device_group(device), device)


def _count(kind: str, x) -> None:
    c = collective_counts[kind]
    c["calls"] += 1
    c["bytes"] += int(x.numel()) * int(x.element_size())
    obs.record_collective(kind, x)


def _wire(x, mesh: Mesh):
    """The tensor the collective runs on: a copy of ``x`` on its device,
    or on the host when gloo takes a CUDA tensor (the explicit copy)."""
    if x.is_cuda and mesh.group is None:
        return x.detach().cpu(), True
    return x.detach().clone().contiguous(), False


def _reduce(x, mesh: Mesh, op, kind: str):
    if mesh.size == 1:
        return x
    import torch.distributed as dist
    _count(kind, x)
    t, moved = _wire(x, mesh)
    dist.all_reduce(t, op=op, group=mesh.group)
    return t.to(x.device) if moved else t


def _psum(x, mesh: Mesh):
    """The sum of ``x`` over the ranks (all_reduce SUM)."""
    import torch.distributed as dist
    return _reduce(x, mesh, dist.ReduceOp.SUM, "psum")


def _pmax(x, mesh: Mesh):
    """The maximum over the ranks (all_reduce MAX): the quantized modes'
    global |g|/|h| maxima, so every rank quantizes in the same units."""
    import torch.distributed as dist
    return _reduce(x, mesh, dist.ReduceOp.MAX, "pmax")


def _all_gather(x, mesh: Mesh):
    """Every rank's ``x`` (equal shapes), stacked: [size, *x.shape]."""
    if mesh.size == 1:
        return x[None]
    import torch.distributed as dist
    _count("all_gather", x)
    t, moved = _wire(x, mesh)
    outs = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(outs, t, group=mesh.group)
    out = torch.stack(outs)
    return out.to(x.device) if moved else out


def pad_rows(mesh: Mesh, n: int) -> int:
    """The row count padded to a multiple of the ranks; padded rows carry
    mask 0 and change nothing."""
    return n + (-n) % mesh.size


def row_block(mesh: Mesh, n: int):
    """(lo, hi): this rank's contiguous block of the ``n`` rows padded
    to ``pad_rows``."""
    s = pad_rows(mesh, n) // mesh.size
    return mesh.rank * s, (mesh.rank + 1) * s


def shard_rows(mesh: Mesh, *arrays, axis: int = 0):
    """This rank's block of each array's row axis (``axis``), zero-padded
    to ``pad_rows`` first: the block ``P("data")`` gives device ``rank``."""
    out = []
    for a in arrays:
        n = a.shape[axis]
        lo, hi = row_block(mesh, n)
        pad = hi - min(hi, n)
        blk = a.narrow(axis, lo, min(hi, n) - min(lo, n)) if lo < n else \
            a.narrow(axis, 0, 0)
        if pad:
            shape = list(a.shape)
            shape[axis] = pad
            blk = torch.cat([blk, torch.zeros(shape, dtype=a.dtype,
                                              device=a.device)], axis)
        out.append(blk.contiguous())
    return tuple(out)


def engine_pad_bins(bins: np.ndarray, D: int, feature_major: bool):
    """The host bin matrix with its row axis padded to a multiple of the
    ranks (done once at trainer set-up)."""
    axis = 1 if feature_major else 0
    pad = (-bins.shape[axis]) % D
    if pad == 0:
        return bins
    widths = [(0, 0), (0, pad)] if feature_major else [(0, pad), (0, 0)]
    return np.pad(bins, widths)


def make_data_parallel_grower(meta, cfg, B: int, mesh: Mesh, phys_bins,
                              B_phys=None, bundled: bool = False):
    """The serial grower on this rank's rows, its leaf histograms (K2) and
    root sums summed across ranks (reference:
    data_parallel_tree_learner.cpp:119-164,246)."""
    return build_grow_fn(meta, cfg, B, phys_bins, B_phys=B_phys,
                         bundled=bundled,
                         reduce_fn=lambda x: _psum(x, mesh))


def make_voting_parallel_grower(meta, cfg, B: int, mesh: Mesh, phys_bins,
                                top_k: int = 20, B_phys=None,
                                bundled: bool = False):
    """Rows sharded, a per-rank top-k feature vote gating the histogram
    exchange (PV-Tree; reference: voting_parallel_tree_learner.cpp:
    170-200,262-377).  A rank votes its ``top_k`` physical columns of
    largest |sum g| (tie-inclusive: every column at or above the k-th
    score); only columns voted by some rank are summed, the rest are
    zero.  Approximate by design; siblings are histogrammed explicitly,
    since two passes may keep different columns.  Under EFB the surviving
    columns ride along so gated-off members skip the default-bin fix."""
    def gated_reduce(x):
        if x.dim() == 3:                       # [F_phys, B_phys, 3]
            k = min(int(top_k), x.shape[0])
            score = x[..., 0].abs().sum(1)
            thresh = torch.topk(score, k).values[-1]
            votes = (score >= thresh).float()
            alive = _psum(votes, mesh) > 0.0
            summed = _psum(torch.where(alive[:, None, None], x,
                                       torch.zeros((), dtype=x.dtype,
                                                   device=x.device)), mesh)
            return (summed, alive) if bundled else summed
        return _psum(x, mesh)

    return build_grow_fn(meta, cfg, B, phys_bins, B_phys=B_phys,
                         bundled=bundled, reduce_fn=gated_reduce,
                         subtract_sibling=False)


def _block_meta(meta: DeviceMeta, lo: int, hi: int, F_block: int):
    """Per-feature metadata of columns [lo, hi), padded to ``F_block``
    with trivial one-bin features (the feature learner takes no EFB)."""
    pad = F_block - (hi - lo)

    def cut(a, fill):
        a = a[lo:hi]
        if pad:
            a = torch.cat([a, torch.full((pad,), fill, dtype=a.dtype,
                                         device=a.device)])
        return a
    dev = meta.num_bins.device
    return DeviceMeta(
        num_bins=cut(meta.num_bins, 1), default_bins=cut(meta.default_bins, 0),
        missing_types=cut(meta.missing_types, 0),
        monotone=cut(meta.monotone, 0), penalties=cut(meta.penalties, 1.0),
        is_categorical=cut(meta.is_categorical, False),
        feat2phys=torch.arange(F_block, dtype=torch.int32, device=dev),
        feat_offset=torch.zeros(F_block, dtype=torch.int32, device=dev),
        needs_fix=torch.zeros(F_block, dtype=torch.bool, device=dev))


def make_feature_parallel_grower(meta, cfg, B: int, mesh: Mesh, phys_bins,
                                 B_phys=None):
    """Features sharded for the search, rows whole on every rank
    (reference: feature_parallel_tree_learner.cpp:33-76).  Each rank
    histograms and scans its block of columns; the winning ``BestSplit``
    comes from one all-gather of every rank's (the 2 x SplitInfo
    allreduce, parallel_tree_learner.h:190-213) and an argmax over the
    gains, the lowest rank winning a tie.  The partition then runs
    locally on the whole rows."""
    F = int(meta.num_bins.shape[0])
    if len(phys_bins) != F:
        raise ValueError("the feature-parallel learner takes no EFB "
                         "bundles")
    F_block = -(-F // mesh.size)
    lo = min(mesh.rank * F_block, F)
    hi = min(lo + F_block, F)
    meta_block = _block_meta(meta, lo, hi, F_block)
    has_cat = bool(meta.is_categorical.any())
    hist_fn = phys_hist_fn(phys_bins, B if B_phys is None else B_phys,
                           cols=np.arange(lo, hi), pad_to=F_block)

    def synced_best_split(hist, sg, sh, sc, min_c, max_c, fmask, pen):
        fm = fmask[..., lo:hi]
        if fm.shape[-1] < F_block:
            fm = torch.cat([fm, torch.zeros(
                fm.shape[:-1] + (F_block - fm.shape[-1],), dtype=fm.dtype,
                device=fm.device)], -1)
        bs = splitter.best_split(hist, sg, sh, sc, meta_block, cfg, min_c,
                                 max_c, feature_mask=fm, has_cat=has_cat)
        feat = torch.where(bs.feature >= 0, bs.feature + lo, bs.feature)
        mine = torch.cat([torch.stack(
            [bs.gain.double(), feat.double(), bs.threshold.double(),
             bs.default_left.double(), bs.left_g.double(),
             bs.left_h.double(), bs.left_c.double(), bs.left_out.double(),
             bs.right_out.double()], -1), bs.cat_bitset.double()], -1)
        every = _all_gather(mine, mesh)                  # [D, n, 9 + W]
        win = torch.argmax(every[..., 0], dim=0)         # [n]
        pick = every[win, torch.arange(every.shape[1], device=win.device)]
        f32 = torch.float32
        return splitter.BestSplit(
            gain=pick[:, 0].to(f32), feature=pick[:, 1].long(),
            threshold=pick[:, 2].long(), default_left=pick[:, 3] > 0,
            left_g=pick[:, 4].to(f32), left_h=pick[:, 5].to(f32),
            left_c=pick[:, 6].to(f32), left_out=pick[:, 7].to(f32),
            right_out=pick[:, 8].to(f32),
            cat_bitset=pick[:, 9:].long().to(torch.int32))

    return build_grow_fn(meta, cfg, B, phys_bins, B_phys=B_phys,
                         hist_fn=hist_fn, best_split_fn=synced_best_split)


def make_data_parallel_wave_grower(meta, cfg, B: int, mesh: Mesh,
                                   **wave_kw):
    """Row-sharded wave growth: K1 histograms this rank's rows, the sum
    across ranks makes every wave's histograms global, and every rank
    replays the same split decisions (reference:
    data_parallel_tree_learner.cpp composed with the GPU learner's
    kernel).  K1 runs unfused: a sibling is parent minus the GLOBAL
    child, taken after the sum (``effective_pipeline(data_parallel=
    True)``), so the trees are those of the fused single-process grower.
    The int16/int8 scales come from the global maxima (``_pmax``)."""
    from ..core.wave_grower import build_wave_grow_fn
    return build_wave_grow_fn(meta, cfg, B,
                              reduce_fn=lambda x: _psum(x, mesh),
                              reduce_max_fn=lambda x: _pmax(x, mesh),
                              **wave_kw)


def make_engine_grower(mode: str, meta, cfg, B: int, mesh: Mesh, phys_bins,
                       wave_kw=None, top_k: int = 20, B_phys=None,
                       bundled: bool = False):
    """The trainer-facing learner (reference: tree_learner.cpp:13-36):
    ``grow(bins, g, h, mask, fmask) -> (tree, leaf_id, (passes, rows))``
    on the WHOLE row vectors, ``leaf_id`` of every row.  Under ``data``
    and ``voting`` ``bins`` is this rank's block of the padded bins
    (``shard_rows``; feature major ``[F, S]`` for the wave grower, the
    serial grower's (narrow, wide) pair otherwise); under ``feature`` it
    is the whole pair.  The leaf ids of the blocks are all-gathered after
    the tree.

    ``mode``: "data" (the wave grower when ``wave_kw`` is given, else the
    serial one), "voting" or "feature"."""
    if mode == "data" and wave_kw is not None:
        inner = make_data_parallel_wave_grower(
            meta, cfg, B, mesh, **{"B_phys": B_phys, "bundled": bundled,
                                   **wave_kw})
    elif mode == "data":
        inner = make_data_parallel_grower(meta, cfg, B, mesh, phys_bins,
                                          B_phys=B_phys, bundled=bundled)
    elif mode == "voting":
        inner = make_voting_parallel_grower(meta, cfg, B, mesh, phys_bins,
                                            top_k=top_k, B_phys=B_phys,
                                            bundled=bundled)
    elif mode == "feature":
        if bundled:
            raise ValueError(
                "EFB-bundled datasets are not supported by the feature-"
                "parallel learner; set enable_bundle=false or use "
                "tree_learner=data/voting/serial")
        return make_feature_parallel_grower(meta, cfg, B, mesh, phys_bins,
                                            B_phys=B_phys)
    else:
        raise ValueError(f"unknown parallel mode: {mode}")

    def grow(bins, g, h, mask, fmask, **kw):
        N = g.shape[0]
        g_l, h_l, m_l = shard_rows(mesh, g, h, mask)
        tree, leaf_l, stats = inner(bins, g_l, h_l, m_l, fmask, **kw)
        leaf = _all_gather(leaf_l.contiguous(), mesh).reshape(-1)[:N]
        return tree, leaf, stats

    return grow
