"""The feature probes: four kernels that a TPU toolchain either lowers or
refuses, run on the card (``csrc/features.cu``).

Counterparts of the JAX package's toolchain watcher probes
(``scripts/toolchain_watch.py``), each on that probe's own shapes and, to
fill the card, on ``units`` tiles of them:

* ``"bf16_cmp"`` (``_probe_bf16_vector_cmp``): ``x > bf16(0.5)`` on bf16
  ``[units, 8, 128]``, as f32 0/1;
* ``"i16_relayout"`` (``_probe_i16_mask_relayout``): f32 ``[units, 8,
  128]`` seen as int16 ``[16, 128]`` tiles (the JAX bitcast layout: rows
  2r, 2r+1 the low and high halves of row r), per column rows 8-15 where
  ``s[u, 0, c] > 0`` else rows 0-7, seen as f32 ``[units, 4, 128]`` again;
* ``"i16_hoisted"`` (``_probe_i16_hoisted_mask``): the same select with
  the probe's mask ``0 - ((s >> 1) & 1)``, broadcast, seen as int16,
  ``< 0``;
* ``"dyn_gather"`` (``_probe_dynamic_gather``): ``tab[u, idx[u, r, c],
  c]`` for f32 ``[units, 64, 128]`` and int32 ``[units, 8, 128]`` in
  [0, 64) (an index outside gives NaN: the kernel reads no memory for
  it, and the wrapper needs no look at the data).

* ``inputs(mode)`` makes the JAX probe's inputs (one tile),
  ``seeded_inputs(mode, units, seed)`` random tiles (every bf16 near 0.5,
  random words with NaN and infinite patterns, every mask bit, every
  table row);
* ``features_reference`` is the plain PyTorch version (``>``,
  ``view(torch.int16)`` + ``torch.where``, ``torch.gather``), written as
  the JAX kernels are;
* ``features`` launches the kernel on CUDA tensors (or raises) and runs
  the plain version on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .dtype import bitcast_i16

MODES = ("bf16_cmp", "i16_relayout", "i16_hoisted", "dyn_gather")
ROWS, COLS, TAB_ROWS = 8, 128, 64
SECTOR = 32  # bytes

# Per mode: the (dtype, tail shape) of each tensor it takes, the kernel's
# mode id and the launch counter's key.
_SELECT = ((torch.float32, (ROWS, COLS)), (torch.int32, (1, COLS)))
_SPECS = {m: (want, MODES.index(m), f"features_{m}") for m, want in (
    ("bf16_cmp", ((torch.bfloat16, (ROWS, COLS)),)),
    ("i16_relayout", _SELECT),
    ("i16_hoisted", _SELECT),
    ("dyn_gather", ((torch.float32, (TAB_ROWS, COLS)),
                    (torch.int32, (ROWS, COLS)))))}


def inputs(mode: str) -> tuple:
    """The JAX probe's inputs, one tile: ``(x,)`` for bf16_cmp (arange / 1024
    in bf16), ``(x, s)`` for the int16 selects (arange + 0.5; ``s`` the
    column index mod 2, or times 2 for the hoisted mask), ``(tab, idx)``
    for the gather (arange, ``(arange * 37) % 64``)."""
    if mode == "bf16_cmp":
        x = torch.arange(ROWS * COLS, dtype=torch.float32).reshape(ROWS, COLS)
        return ((x / 1024.0).to(torch.bfloat16),)
    if mode in ("i16_relayout", "i16_hoisted"):
        x = torch.arange(ROWS * COLS, dtype=torch.float32).reshape(ROWS, COLS)
        c = torch.arange(COLS, dtype=torch.int32)
        s = (c % 2 if mode == "i16_relayout" else c * 2).reshape(1, COLS)
        return x + 0.5, s.to(torch.int32)
    if mode == "dyn_gather":
        tab = torch.arange(TAB_ROWS * COLS, dtype=torch.float32)
        idx = (torch.arange(ROWS * COLS, dtype=torch.int32) * 37) % TAB_ROWS
        return tab.reshape(TAB_ROWS, COLS), idx.reshape(ROWS, COLS)
    raise ValueError(f"unknown feature mode {mode!r}")


def seeded_inputs(mode: str, units: int, seed: int = 0) -> tuple:
    """Random tiles with a leading ``units``: bf16 values in [0.25, 0.75)
    (many exactly 0.5 and its neighbours), random 32-bit words (NaN and
    infinite patterns included: the selects move bits) with random
    int32 masks, or a random table and indices."""
    rng = np.random.default_rng(seed)
    if mode == "bf16_cmp":
        x = rng.uniform(0.25, 0.75, size=(units, ROWS, COLS)).astype(np.float32)
        return (torch.from_numpy(x).to(torch.bfloat16),)
    if mode in ("i16_relayout", "i16_hoisted"):
        x = rng.integers(-(1 << 31), 1 << 31, size=(units, ROWS, COLS),
                         dtype=np.int64).astype(np.int32)
        s = rng.integers(-(1 << 31), 1 << 31, size=(units, 1, COLS),
                         dtype=np.int64).astype(np.int32)
        return torch.from_numpy(x).view(torch.float32), torch.from_numpy(s)
    if mode == "dyn_gather":
        tab = rng.standard_normal(size=(units, TAB_ROWS, COLS)).astype(np.float32)
        idx = rng.integers(0, TAB_ROWS, size=(units, ROWS, COLS)).astype(np.int32)
        return torch.from_numpy(tab), torch.from_numpy(idx)
    raise ValueError(f"unknown feature mode {mode!r}")


def _check(mode: str, args: tuple) -> None:
    spec = _SPECS.get(mode)
    if spec is None:
        raise ValueError(f"unknown feature mode {mode!r}")
    want = spec[0]
    if len(args) != len(want):
        raise ValueError(f"{mode} takes {len(want)} tensors, got {len(args)}")
    lead, dev = args[0].shape[:-2], args[0].device
    for t, (dtype, tail) in zip(args, want):
        shape = t.shape
        if t.dtype != dtype or shape[-2:] != tail or shape[:-2] != lead:
            raise ValueError(f"{mode}: want {dtype} [..., {tail[0]}, {tail[1]}] "
                             f"with one leading shape, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{mode}: tensors on {t.device} and {dev}")


def bitcast_32(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``bitcast_i16``'s inverse: int16 ``[..., 2R, 128]`` to ``dtype``
    ``[..., R, 128]``."""
    h = t.unflatten(-2, (t.shape[-2] // 2, 2)).transpose(-1, -2).contiguous()
    return h.view(dtype).squeeze(-1)


def features_reference(mode: str, *args: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of each probe kernel (see the module
    docstring)."""
    _check(mode, args)
    if mode == "bf16_cmp":
        (x,) = args
        m = x > torch.tensor(0.5, dtype=torch.bfloat16)
        return torch.where(m, 1.0, 0.0).to(torch.float32)
    if mode == "dyn_gather":
        tab, idx = args
        ok = (idx >= 0) & (idx < TAB_ROWS)
        got = torch.gather(tab, -2, torch.where(ok, idx, 0).long())
        return torch.where(ok, got, torch.nan)
    x, s = args
    t = bitcast_i16(x)
    if mode == "i16_relayout":
        m = s > 0
    else:
        m32 = 0 - ((s >> 1) & 1)
        m32 = m32.expand(*s.shape[:-2], ROWS, COLS).contiguous()
        m = (bitcast_i16(m32) < 0)[..., :ROWS, :]
    r = torch.where(m, t[..., ROWS:, :], t[..., :ROWS, :])
    return bitcast_32(r, torch.float32)


def features(mode: str, *args: torch.Tensor) -> torch.Tensor:
    """``features_reference``'s function: CUDA tensors launch
    ``csrc/features.cu`` (or raise), CPU tensors run the plain version."""
    _check(mode, args)
    if args[0].is_cuda:
        return _launch_cuda(mode, args)
    dev = args[0].device
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return features_reference(mode, *args)


def nbytes(mode: str, *args: torch.Tensor) -> int:
    """Bytes that one call on ``args`` must move: the output written once,
    and of each input the 32-byte sectors (the card's unit of a memory
    access) that the output depends on, read once. Counted from this
    call's data: the gather needs the table only where ``idx`` points (an
    index outside reads nothing), an int16 select only the half of ``x``
    that each column's mask picks."""
    _check(mode, args)
    units = args[-1].numel() // (args[-1].shape[-2] * COLS)
    words = SECTOR // 4          # 32-bit words in a sector
    groups = COLS // words       # sectors in a row of 128 words
    if mode == "bf16_cmp":
        return units * ROWS * COLS * (2 + 4)
    if mode == "dyn_gather":
        idx = args[1].reshape(units, ROWS, COLS).long()
        ok = (idx >= 0) & (idx < TAB_ROWS)
        unit = torch.arange(units, device=idx.device).view(-1, 1, 1)
        col = torch.arange(COLS, device=idx.device) // words
        sector = (unit * TAB_ROWS + idx.clamp(0, TAB_ROWS - 1)) * groups + col
        hit = torch.zeros(units * TAB_ROWS * groups, dtype=torch.bool,
                          device=idx.device)
        hit[sector[ok]] = True
        return int(hit.sum()) * SECTOR + units * ROWS * COLS * (4 + 4)
    s = args[1].reshape(units, groups, words)
    m = s > 0 if mode == "i16_relayout" else ((s >> 1) & 1) != 0
    # Per unit and sector column: the f32 rows 0-3 (mask false) or 4-7.
    halves = int(m.any(-1).sum()) + int((~m).any(-1).sum())
    return (halves * (ROWS // 2) * SECTOR
            + units * (4 * COLS + 4 * ROWS // 2 * COLS))


def _output(mode: str, args: tuple) -> torch.Tensor:
    """The f32 output for ``args``, allocated at the least host cost.
    bf16_cmp's kernel loads 16-byte vectors from the first 16-byte
    boundary of x and stores them at the same value of the output, which
    must then be 16-byte aligned too: for an x off its boundary the output
    is a view that far into a block of the allocator's (which aligns every
    block). dyn_gather's table is read in 16-byte vectors: it must be
    16-byte aligned (``ValueError``)."""
    a = args[0]
    if mode in ("i16_relayout", "i16_hoisted"):
        return a.new_empty((*a.shape[:-2], ROWS // 2, COLS))
    off = a.data_ptr() % 16
    if mode == "dyn_gather":
        if off:
            raise ValueError(f"dyn_gather: tab must be 16-byte aligned (its "
                             f"data_ptr() % 16 is {off})")
        return torch.empty_like(args[1], dtype=torch.float32)
    if off == 0:
        return torch.empty_like(a, dtype=torch.float32)
    o = -((16 - off) // 2) % 4
    buf = a.new_empty(a.numel() + o, dtype=torch.float32)
    return buf[o:].view(a.shape)


def _launch_cuda(mode, args):
    for t in args:
        if not t.is_contiguous():
            raise ValueError(f"{mode}: tensors must be contiguous")
    _, mode_id, key = _SPECS[mode]
    a = args[0]
    units = args[-1].numel() // (args[-1].shape[-2] * COLS)
    out = _output(mode, args)
    b = args[1].data_ptr() if len(args) > 1 else None
    _build.launch("features", "rt_features_launch", a.device, a.data_ptr(),
                  b, out.data_ptr(), units, mode_id, count=key)
    return out
