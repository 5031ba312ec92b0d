"""The worklist probe: what the granularity of a culled sweep's skips
costs, on one sweep body over fixed votes.

Counterpart of the JAX package's probe kernel (``scripts/probe_worklist.py``:
``make_kernel``, ``_group_body``, ``build``). One unit is 1,024 rays in 8
groups of 128 lanes against 8 blocks of 512 table rows (columns cx, cy, cz,
-2cx, -2cy, -2cz, cm2). Per (block, group) the body is the flat sphere
sweep's key with row-in-block ids, ``(bits(key) & ~511) | row``, min'd from
``_NOHIT`` each pass; the result is each ray's key min summed over ``reps``
passes in wrapping int32. ``votes[b, g]`` says whether group g sweeps block
b:

* ``"static"``: a block any group votes for is swept by every group (the
  JAX package's one cond per block). With a vote table that is not
  conservative it sweeps more pairs, so it equals the others only when
  every group votes for every block it visits;
* ``"conds"``: each group sweeps only the blocks it votes for;
* ``"worklist"``: the same pairs as ``"conds"``, compacted into a list of
  work items (the same result).

* ``inputs`` makes the JAX probe's inputs (``_inputs``, the same numpy
  generator calls), and ``payloads`` the per-unit ray payloads of its
  timing loop;
* ``worklist_reference`` is the plain PyTorch version (roots through f64,
  rounded once to f32: the correctly rounded f32 square root on every
  device);
* ``worklist_probe`` launches ``csrc/worklist.cu`` on CUDA tensors (or
  raises) and runs the plain version on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cull as rcull

BLK = 512      # rows per block
NB = 8         # blocks per pass
GROUPS = 8     # ray groups of a unit
LANES = 128    # rays per group
UNIT = GROUPS * LANES
MODES = ("static", "conds", "worklist")
_BIGF = 3.0e38
_NOHIT = int(np.float32(_BIGF).view(np.int32)) & ~(BLK - 1)

# Launches of csrc/worklist.cu per mode.
launch_counts = {f"worklist_{m}": 0 for m in MODES}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def inputs(pass_groups: int, seed: int = 0):
    """``(tab f32[4096, 7], rays f32[48, 128], votes i32[8, 8])`` of the
    JAX probe's ``_inputs``: normal table columns (cm2 = 30 |N|), normal
    rays, and ``pass_groups`` of the 8 groups voting for each block,
    rotating with the block."""
    rng = np.random.default_rng(seed)
    tab = rng.normal(size=(NB * BLK, 7)).astype(np.float32)
    tab[:, 6] = np.abs(tab[:, 6]) * 30.0
    rays = rng.normal(size=(6 * GROUPS, LANES)).astype(np.float32)
    votes = np.zeros((NB, GROUPS), np.int32)
    for b in range(NB):
        for k in range(pass_groups):
            votes[b, (b + k) % GROUPS] = 1
    return torch.from_numpy(tab), torch.from_numpy(rays), torch.from_numpy(votes)


def payloads(rays: torch.Tensor, units: int) -> torch.Tensor:
    """f32 [units, 48, 128]: unit i's rays scaled by f32(1 + 1e-4 i), the
    JAX timing loop's distinct payloads."""
    scale = torch.tensor([np.float32(1.0 + 1e-4 * i) for i in range(units)],
                         dtype=torch.float32, device=rays.device)
    return rays[None] * scale[:, None, None]


def _check(tab, rays, votes, reps, mode):
    if mode not in MODES:
        raise ValueError(f"unknown worklist mode {mode!r}")
    if tab.dtype != torch.float32 or tuple(tab.shape) != (NB * BLK, 7):
        raise ValueError(f"tab must be float32 [{NB * BLK}, 7]")
    if rays.dtype != torch.float32 or rays.dim() != 3 or \
            tuple(rays.shape[1:]) != (6 * GROUPS, LANES) or rays.shape[0] < 1:
        raise ValueError(f"rays must be float32 [units, {6 * GROUPS}, {LANES}]")
    if votes.dtype != torch.int32 or tuple(votes.shape) != (NB, GROUPS):
        raise ValueError(f"votes must be int32 [{NB}, {GROUPS}]")
    if not (tab.device == rays.device == votes.device):
        raise ValueError("tab, rays and votes must be on one device")
    if reps < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")


def swept_pairs(votes: torch.Tensor, mode: str) -> int:
    """(block, group) pairs one pass of ``mode`` sweeps under ``votes``."""
    v = votes.cpu() > 0
    if mode == "static":
        return int(v.any(dim=1).sum()) * GROUPS
    return int(v.sum())


def worklist_reference(tab, rays, votes, reps: int, mode: str):
    """Plain PyTorch version: int32 [units, 8, 128], each ray's key min
    over the (block, group) pairs ``mode`` sweeps, times ``reps`` in
    wrapping int32 (every pass computes the same minimum)."""
    _check(tab, rays, votes, reps, mode)
    dev = tab.device
    ox, oy, oz, dx, dy, dz = (rays[:, c * GROUPS:(c + 1) * GROUPS, :, None]
                              for c in range(6))
    a = dx * dx + dy * dy + dz * dz
    ddo = dx * ox + dy * oy + dz * oz
    oo = ox * ox + oy * oy + oz * oz
    ta = 1.0e-4 * a
    ids = torch.arange(BLK, dtype=torch.int32, device=dev)
    carry = torch.full(a.shape[:3], _NOHIT, dtype=torch.int32, device=dev)
    vote = votes > 0
    for b in range(NB):
        if not bool(vote[b].any()):
            continue
        # Every group's keys against the block; the mode picks the groups
        # whose minimum takes them.
        cx, cy, cz, m2cx, m2cy, m2cz, cm2 = tab[b * BLK:(b + 1) * BLK].t()
        h = cx * dx + cy * dy + cz * dz - ddo
        cq = cm2 + m2cx * ox + m2cy * oy + m2cz * oz + oo
        delta = h * h - a * cq
        sq = rcull._sqrt(delta)
        n1 = h - sq
        n2 = h + sq
        nroot = torch.where(n1 > ta, n1, n2)
        key = torch.where(nroot > ta, nroot, _BIGF)
        ki = (key.view(torch.int32) & ~(BLK - 1)) | ids
        swept = vote[b] | (mode == "static")
        carry = torch.where(swept[None, :, None],
                            torch.minimum(carry, ki.min(dim=-1).values), carry)
    acc = (carry.long() * reps) % (1 << 32)
    return torch.where(acc >= 1 << 31, acc - (1 << 32), acc).to(torch.int32)


def worklist_probe(tab, rays, votes, reps: int, mode: str):
    """The probe (``worklist_reference``'s arguments and result): CUDA
    tensors launch ``csrc/worklist.cu`` (one CTA of 1,024 threads a unit)
    or raise, CPU tensors run the plain version."""
    _check(tab, rays, votes, reps, mode)
    dev = tab.device
    if dev.type == "cuda":
        return _launch_cuda(tab, rays, votes, reps, mode)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return worklist_reference(tab, rays, votes, reps, mode)


def _launch_cuda(tab, rays, votes, reps, mode):
    from . import _build

    for name, t in (("tab", tab), ("rays", rays), ("votes", votes)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    units = rays.shape[0]
    out = torch.empty((units, GROUPS, LANES), dtype=torch.int32,
                      device=tab.device)
    lib = _build.load("worklist")
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream(tab.device).cuda_stream
        err = lib.rt_worklist_launch(tab.data_ptr(), rays.data_ptr(),
                                     votes.data_ptr(), units, reps,
                                     MODES.index(mode), out.data_ptr(),
                                     stream)
    if err != 0:
        raise RuntimeError(f"worklist kernel launch failed: "
                           f"{_build.error_string(lib, err)}")
    launch_counts[f"worklist_{mode}"] += 1
    return out
