"""The winner fetch: the words of row ``sel`` of a table, bit for bit.

Counterpart of the JAX package's radix winner fetch
(``raytracing_tpu/ops/pallas/trace.py``: ``_fold_half``, ``_fold8``,
``_fold_to_row``, ``_gather_cols``, ``_gather``, and the window collapse
``_collapse_window_blocked``) and of its one-hot matrix-unit fetch
(``_gather_mxu``, ``_collapse_window_mxu``), which ``RT_GATHER`` and
``RT_TWO_LEVEL_MXU`` choose between.

* ``env_settings`` reads those two variables exactly as the JAX package
  reads them (neither is validated there, so none is here), and
  ``route_flags`` turns them, or a caller's ``gather=`` override, into the
  megakernel's two route flags: ``radix_rows`` (the flat sphere winner with
  its textured columns, the texel and the flat triangle winner) and
  ``radix_windows`` (the two-level stage-2 windows of spheres and
  triangles, and the two-level winners folded out of them).
* ``fetch_rows_reference`` is the plain PyTorch version in three modes:
  ``"index"`` (``table[sel]``), ``"radix"`` (the literal halving
  tournament on int32 words, ``torch.where`` on ``sel``'s bits, as
  ``_fold_half`` / ``_fold8`` do) and ``"onehot"`` (float32 byte planes
  times a one-hot matrix, rebuilt with integer ops, as ``_gather_mxu``
  does). The plain megakernel (``ops/trace.py``) calls it at its fetch
  sites when the route flags are set.
* ``fetch_rows`` is the standalone fetch of ``csrc/fetch.cu`` (the
  counterpart of the JAX package's fetch test kernel and fetch probes) on
  CUDA tensors, and of ``fetch_loop_reference`` on CPU tensors; it raises
  on anything else.

Packed words stay int32 end to end: the gray albedo word 0x80008000 is a
subnormal float32 pattern and the white dielectric word 0xFFFFFFFF a NaN,
and a float op on either may change it.
"""

from __future__ import annotations

import os

import torch

ROUTES = ("index", "radix", "windows")
MODES = ("index", "radix", "onehot", "radix16")
_MODE_IDS = {"index": 0, "radix": 1, "onehot": 2, "radix16": 3}

# Rows of the JAX package's collapse window (_SWEEP_ROWS): a tournament
# over more rows first selects the lane's 512-row window by its index.
_WINDOW_ROWS = 512
# Elements a plain tournament or one-hot product holds at once.
_ELEMS = 1 << 24
# Columns the fetch kernel takes (its radix mode is compiled per count).
MAX_COLS = 16

# Launches of csrc/fetch.cu per mode (``fetch_rows``).
launch_counts = {f"fetch_{m}": 0 for m in MODES}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def env_settings() -> tuple[bool, bool]:
    """``(radix_rows, radix_windows)`` from the environment, read as the
    JAX package reads them (``_mxu_enabled``, ``_two_level_mxu``):

    * ``RT_GATHER``: "radix" takes the radix fetch everywhere; any other
      value (the JAX package's default is "mxu") keeps the default route;
    * ``RT_TWO_LEVEL_MXU``: "0" takes the radix collapse for the two-level
      windows alone; any other value keeps the default.

    Neither variable is validated, so the same environment picks the same
    route in both packages."""
    rows = os.environ.get("RT_GATHER", "mxu") == "radix"
    windows = rows or os.environ.get("RT_TWO_LEVEL_MXU", "1") == "0"
    return rows, windows


def route_flags(gather: str | None = None) -> tuple[bool, bool]:
    """``(radix_rows, radix_windows)`` of a ``gather=`` argument: None
    takes the environment (``env_settings``); "index" is the default route
    (indexed loads), "radix" the radix fetch at every fetch site, and
    "windows" the radix collapse at the two-level windows alone."""
    if gather is None:
        return env_settings()
    if gather not in ROUTES:
        raise ValueError(f"gather must be None or one of {ROUTES}, got {gather!r}")
    return gather == "radix", gather in ("radix", "windows")


def _words(table: torch.Tensor) -> torch.Tensor:
    """A 2-D table of 4-byte values as its int32 words (no float op)."""
    if table.dim() != 2 or table.element_size() != 4:
        raise ValueError(f"table must be 2-D with 4-byte entries, got "
                         f"{tuple(table.shape)} {table.dtype}")
    return table.contiguous().view(torch.int32)


def _bit(sel: torch.Tensor, k: int) -> torch.Tensor:
    """Bit ``k`` of each lane's selection, shaped to select [rows, lanes,
    cols] tiles."""
    return ((sel >> k) & 1).bool()[None, :, None]


def _fold_half(t: torch.Tensor, sel: torch.Tensor, stop: int = 8):
    """``_fold_half``: each level keeps the half of the rows holding every
    lane's selection, down to ``stop`` rows. ``t`` is [rows, 1 | lanes,
    cols]."""
    size = t.shape[0]
    while size > stop:
        half = size // 2
        t = torch.where(_bit(sel, half.bit_length() - 1), t[half:size], t[:half])
        size = half
    return t


def _fold8(t: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``_fold8``: three rotate-select rounds collapse 8 rows to the
    selected one."""
    for shift in (4, 2, 1):
        rolled = torch.roll(t, 8 - shift, dims=0)
        t = torch.where(_bit(sel, shift.bit_length() - 1), rolled, t)
    return t[0]


def _fold_to_row(t: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``_fold_to_row``: [rows, 1 | lanes, cols] -> each lane's row
    ``sel`` as [lanes, cols] (rows a power of two)."""
    rows = t.shape[0]
    if rows < 8:
        return _fold_half(t, sel, stop=1)[0].expand(sel.shape[0], -1)
    return _fold8(_fold_half(t, sel), sel).expand(sel.shape[0], -1)


def _radix(words: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``_gather_cols`` on one chunk of lanes: past ``_WINDOW_ROWS`` rows
    a select over window slices keyed on the window index first collapses
    each lane's window, then the tournament folds it."""
    n = words.shape[0]
    if n <= _WINDOW_ROWS:
        return _fold_to_row(words[:, None, :], sel)
    blk = sel >> (_WINDOW_ROWS.bit_length() - 1)
    t = torch.zeros((_WINDOW_ROWS, sel.shape[0], words.shape[1]),
                    dtype=torch.int32, device=words.device)
    for b in range(n // _WINDOW_ROWS):
        win = words[b * _WINDOW_ROWS:(b + 1) * _WINDOW_ROWS, None, :]
        t = torch.where((blk == b)[None, :, None], win, t)
    return _fold_to_row(t, sel)


def _onehot(words: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``_gather_mxu`` on one chunk of lanes: float32 byte planes [4C, N]
    (row 4c + k = byte k of column c, exact in bf16) times the one-hot
    [N, lanes] matrix (one nonzero product per sum), each word rebuilt as
    ``((p3*256 + p2) << 16) | (p1*256 + p0)`` in int32."""
    n, c = words.shape
    planes = torch.stack([(words >> (8 * k)) & 0xFF for k in range(4)],
                         dim=-1)  # [N, C, 4]
    planes = planes.reshape(n, 4 * c).t().to(torch.float32)
    iota = torch.arange(n, device=words.device)
    onehot = (iota[:, None] == sel[None, :]).to(torch.float32)
    p = torch.matmul(planes, onehot).view(c, 4, -1)
    hi = (p[:, 3] * 256.0 + p[:, 2]).to(torch.int32)
    lo = (p[:, 1] * 256.0 + p[:, 0]).to(torch.int32)
    return ((hi << 16) | lo).t()


def fetch_rows_reference(table: torch.Tensor, sel: torch.Tensor,
                         mode: str = "radix") -> torch.Tensor:
    """Row ``sel[i]`` of ``table`` for every lane ``i``, as int32 words
    [lanes, C], bit for bit in every mode ("index", "radix" or "onehot";
    "radix16" is the radix tournament too: only the kernel's registers
    differ). ``table`` is [N, C] of any 4-byte type, N a power of two;
    every ``sel`` lies in [0, N)."""
    words = _words(table)
    sel = sel.to(words.device).long()
    if mode == "index":
        return words[sel]
    if mode not in MODES:
        raise ValueError(f"unknown fetch mode {mode!r}")
    n, c = words.shape
    if n & (n - 1):
        raise ValueError(f"table rows {n} must be a power of two")
    fn = _onehot if mode == "onehot" else _radix
    # Lanes a chunk: the one-hot column plus its planes' products, or the
    # tournament's first level (at most one window of rows).
    width = n + 4 * c if mode == "onehot" else min(n, _WINDOW_ROWS) * c
    per = max(1, _ELEMS // width)
    if sel.numel() <= per:
        return fn(words, sel)
    return torch.cat([fn(words, sel[i:i + per])
                      for i in range(0, sel.numel(), per)], dim=0)


def collapse_windows_reference(table: torch.Tensor, win: torch.Tensor,
                               win_rows: int, mode: str) -> torch.Tensor:
    """Each lane's window ``win[i]`` of ``win_rows`` rows, as int32 words
    [lanes, win_rows, C]: the two-level stage-2 collapse
    (``_collapse_window_blocked`` for "radix", ``_collapse_window_mxu`` for
    "onehot", an indexed load for "index"), a fetch over the table's
    windows taken as rows of ``win_rows * C`` words."""
    words = _words(table)
    n, c = words.shape
    flat = words.reshape(n // win_rows, win_rows * c)
    out = fetch_rows_reference(flat, win, mode)
    return out.reshape(-1, win_rows, c)


def fold_rows_reference(t: torch.Tensor, sel: torch.Tensor,
                        mode: str) -> torch.Tensor:
    """Row ``sel[i]`` of each lane's own table ``t[i]`` ([lanes, rows, C]
    int32 -> [lanes, C]): the winner row folded out of a collapsed window.
    The JAX package folds it with ``_fold_to_row`` whatever fetched the
    window, so "radix" and "onehot" fold; "index" loads."""
    sel = sel.long()
    if mode == "index":
        return t[torch.arange(t.shape[0], device=t.device), sel]
    return _fold_to_row(t.transpose(0, 1), sel)


def next_selection(h: torch.Tensor, k: int, n_rows: int) -> torch.Tensor:
    """The iterated fetch's next selection (``scripts/probe_mxu_loop.py``):
    ``(|h| + k) & (n_rows - 1)`` in int32 arithmetic (only low bits
    survive the mask, so int64 gives the same ones)."""
    return (h.long().abs() + k) & (n_rows - 1)


def fetch_loop_reference(table: torch.Tensor, sel: torch.Tensor,
                         mode: str = "radix", iters: int = 1) -> torch.Tensor:
    """The plain version of ``fetch_rows``: ``iters`` fetches, each
    selection after the first fed back from the words fetched so far
    (``h ^= every word; sel = (|h| + k) & (n_rows - 1)``). Returns the
    last fetch's words as int32 [C, lanes]."""
    words = _words(table)
    s = sel.to(words.device).long()
    h = torch.zeros(s.shape, dtype=torch.int32, device=words.device)
    for k in range(iters):
        w = fetch_rows_reference(words, s, mode)
        for c in range(w.shape[1]):
            h = h ^ w[:, c]
        s = next_selection(h, k, words.shape[0])
    return w.t().contiguous()


def fetch_rows(table: torch.Tensor, sel: torch.Tensor, mode: str = "radix",
               iters: int = 1) -> torch.Tensor:
    """Fetch row ``sel[g]`` of ``table`` (int32 [N, C], N a power of two,
    C <= 16) for every lane ``g`` of ``sel`` (int32 [G], values in [0,
    N)), ``iters`` times with the selection fed back as in
    ``fetch_loop_reference``; returns the last fetch's words as int32
    [C, G].

    CUDA tensors launch ``csrc/fetch.cu`` in ``mode``: "index" (indexed
    loads), "radix" (the tournament on 32-bit words that ``regen.cu``'s
    radix route runs), "radix16" (the same tournament on two 16-bit halves
    per register, selected with ``__byte_perm``) or "onehot" (byte planes
    times a one-hot matrix on the tensor cores, ``mma.sync`` bf16 with f32
    accumulation); CPU tensors run ``fetch_loop_reference``."""
    if mode not in MODES:
        raise ValueError(f"unknown fetch mode {mode!r}")
    if table.dtype != torch.int32 or table.dim() != 2:
        raise TypeError(f"table must be int32 [N, C], got {table.dtype} "
                        f"{tuple(table.shape)}")
    n, c = table.shape
    if n < 1 or n & (n - 1):
        raise ValueError(f"table rows {n} must be a power of two")
    if not 1 <= c <= MAX_COLS:
        raise ValueError(f"table columns {c} must be in [1, {MAX_COLS}]")
    if sel.dtype != torch.int32 or sel.dim() != 1 or sel.numel() == 0:
        raise TypeError("sel must be a non-empty int32 [G] tensor")
    if sel.device != table.device:
        raise ValueError(f"sel is on {sel.device}, table on {table.device}")
    if not (table.is_contiguous() and sel.is_contiguous()):
        raise ValueError("table and sel must be contiguous")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    if table.device.type == "cuda":
        return _launch_fetch_cuda(table, sel, mode, iters)
    if table.device.type != "cpu":
        raise ValueError(f"unsupported device {table.device}")
    return fetch_loop_reference(table, sel, mode, iters)


def _launch_fetch_cuda(table, sel, mode, iters):
    from . import _build

    n, c = table.shape
    g = sel.numel()
    out = torch.empty((c, g), dtype=torch.int32, device=table.device)
    lib = _build.load("fetch")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.rt_fetch_launch(table.data_ptr(), n, c, sel.data_ptr(), g,
                                  out.data_ptr(), _MODE_IDS[mode], iters,
                                  stream)
    if err != 0:
        raise RuntimeError(
            f"fetch kernel launch failed: {_build.error_string(lib, err)}"
        )
    launch_counts[f"fetch_{mode}"] += 1
    return out
