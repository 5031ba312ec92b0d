"""The winner fetch: the words of row ``sel`` of a table, bit for bit.

Counterpart of the JAX package's radix winner fetch
(``raytracing_tpu/ops/pallas/trace.py``: ``_fold_half``, ``_fold8``,
``_fold_to_row``, ``_gather_cols``, ``_gather``, and the window collapse
``_collapse_window_blocked``) and of its one-hot matrix-unit fetch
(``_gather_mxu``, ``_collapse_window_mxu``, on the planes of
``_plane_table_int``), which ``RT_GATHER`` and ``RT_TWO_LEVEL_MXU`` choose
between.

* ``env_settings`` reads those two variables exactly as the JAX package
  reads them (neither is validated there, so none is here), and
  ``route_flags`` turns them, or a caller's ``gather=`` override, into the
  megakernel's two route flags: ``radix_rows`` (the flat sphere winner with
  its textured columns, the texel and the flat triangle winner) and
  ``radix_windows`` (the two-level stage-2 windows of spheres and
  triangles, and the two-level winners folded out of them).
* ``fetch_rows_reference`` is the plain PyTorch version in three modes:
  ``"index"`` (``table[sel]``), ``"radix"`` (the JAX package's halving
  tournament on int32 words, ``torch.where`` on ``sel``'s bits, as
  ``_fold_half`` / ``_fold8`` do) and ``"onehot"`` (the byte planes of
  ``plane_table_reference`` times a one-hot matrix, rebuilt with integer
  ops, as ``_gather_mxu`` does). The plain megakernel (``ops/trace.py``)
  calls it at its fetch sites when the route flags are set.
* ``exchange_reference`` models the card's radix fetch
  (``csrc/fetch.cuh``): the lanes of a warp that reach the fetch together
  walk the table in chunks of as many rows as they are, each reading the
  row of its rank, and take each word from the lane of rank ``sel - i0``.
  ``plane_table_reference`` is the one-hot mode's bf16 planes and
  ``plane_tiles_reference`` their layout in the prepass's scratch (the
  K-major core matrices ``wgmma`` reads).
* ``fetch_rows`` is the standalone fetch of ``csrc/fetch.cu`` (the
  counterpart of the JAX package's fetch test kernel and fetch probes) on
  CUDA tensors, and of ``fetch_loop_reference`` on CPU tensors; it raises
  on anything else. ``fetch_planes`` is its one-hot prepass.

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
# The one-hot planes' least row count (csrc/fetch.cu: kOhKAlign), which
# the plain prepass pads to.
_PLANE_ROWS = 128

# Lanes of a warp, the radix exchange's largest group, and the largest
# table the exchange's model sweeps instead (csrc/fetch.cuh: kSweepRows;
# ``kernel_sweep_rows`` reads the built kernel's).
WARP = 32
SWEEP_ROWS = 4


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


def plane_shape(n_rows: int, cols: int) -> tuple[int, int]:
    """(K, N) of the one-hot mode's planes: the table's rows (a power of
    two) rounded up to 128, two batches of four 16-row ``wgmma`` steps, and
    4 byte planes a column rounded up to 8."""
    return max(_PLANE_ROWS, n_rows), -(-4 * cols // 8) * 8


def plane_streams(n_rows: int, cols: int) -> bool:
    """Whether the built one-hot kernel streams the planes of an ``n_rows``
    x ``cols`` table through shared memory in chunks (TMA), rather than
    holding them resident: the launcher's own choice
    (``rt_fetch_plane_streams``)."""
    from . import _build

    return bool(_build.load("fetch").rt_fetch_plane_streams(n_rows, cols))


def kernel_sweep_rows() -> int:
    """The largest table the built radix modes sweep rather than exchange
    (``kSweepRows`` of ``csrc/fetch.cuh``), for checks that
    ``SWEEP_ROWS`` models the kernel."""
    from . import _build

    return int(_build.load("fetch").rt_fetch_sweep_rows())


def plane_table_reference(words: torch.Tensor) -> torch.Tensor:
    """The bf16 byte planes [N_rows, N] of int32 words [N_rows, C]: column
    4c + k holds byte k (0..255, exact in bf16) of column c, columns past
    4C are 0. The transpose of ``_plane_table_int``'s f32 (pad8(4C),
    N_rows), padded as it pads."""
    n, c = words.shape
    planes = torch.stack([(words >> (8 * k)) & 0xFF for k in range(4)],
                         dim=-1).reshape(n, 4 * c)
    pad = plane_shape(n, c)[1] - 4 * c
    if pad:
        planes = torch.cat([planes, planes.new_zeros((n, pad))], dim=1)
    return planes.to(torch.bfloat16)


def plane_tiles_reference(planes: torch.Tensor) -> torch.Tensor:
    """The prepass's scratch (``csrc/fetch.cu``: ``fetch_planes``) as int16
    [K * N]: ``planes`` [N_rows, N] bf16 padded with zero rows to K, cut
    into 8 x 8 core matrices, core (k // 8, n // 8) at ((k // 8) * N / 8 +
    n // 8) * 64, its row n % 8 at stride 8 and k % 8 within."""
    n, width = planes.shape
    k_pad = plane_shape(n, width // 4)[0]
    bits = planes.view(torch.int16)
    if k_pad > n:
        bits = torch.cat([bits, bits.new_zeros((k_pad - n, width))])
    tiles = bits.reshape(k_pad // 8, 8, width // 8, 8).permute(0, 2, 3, 1)
    return tiles.reshape(-1).contiguous()


def onehot_product_reference(planes: torch.Tensor, sel: torch.Tensor,
                             cols: int) -> torch.Tensor:
    """``_gather_mxu`` over bf16 planes [N_rows, N]: the f32 planes times
    the one-hot [N_rows, lanes] matrix (one nonzero product per sum), each
    word rebuilt as ``((p3*256 + p2) << 16) | (p1*256 + p0)`` in int32;
    returns [lanes, cols]."""
    n = planes.shape[0]
    t = planes[:, :4 * cols].t().to(torch.float32)
    iota = torch.arange(n, device=planes.device)
    onehot = (iota[:, None] == sel[None, :]).to(torch.float32)
    p = torch.matmul(t, onehot).view(cols, 4, -1)
    hi = (p[:, 3] * 256.0 + p[:, 2]).to(torch.int32)
    lo = (p[:, 1] * 256.0 + p[:, 0]).to(torch.int32)
    return ((hi << 16) | lo).t()


def _onehot(words: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``_gather_mxu`` on one chunk of lanes, over the table's planes."""
    return onehot_product_reference(plane_table_reference(words), sel,
                                     words.shape[1])


def exchange_reference(words: torch.Tensor, sel: torch.Tensor,
                       active: torch.Tensor | None = None) -> torch.Tensor:
    """The card's radix fetch (``csrc/fetch.cuh``: ``radix_select``), step
    by step: lanes are cut into warps of 32 (the last may be ragged), and
    a warp's ``active`` lanes (all lanes when None) form its group. With m
    lanes in the group and r a lane's rank among them, the group walks the
    table in chunks of m rows: at chunk i0 the lane of rank r reads row
    min(i0 + r, N - 1), and every lane whose ``sel`` lies in [i0, i0 + m)
    takes that row's words from the lane of rank ``sel - i0``. Tables of
    at most ``SWEEP_ROWS`` rows are swept instead: every lane reads every
    row and keeps its own. Returns int32 [lanes, C]; inactive lanes, and
    lanes whose ``sel`` lies outside [0, N), get 0 (the kernel writes
    nothing for the former and keeps nothing for the latter)."""
    words = _words(words)
    n, c = words.shape
    lanes = sel.numel()
    if active is None:
        active = torch.ones(lanes, dtype=torch.bool)
    if n <= SWEEP_ROWS:
        out = torch.zeros((lanes, c), dtype=torch.int32, device=words.device)
        take = active.to(words.device)
        for i in range(n):
            out = torch.where(((sel.to(words.device) == i) & take)[:, None],
                              words[i], out)
        return out
    nw = -(-lanes // WARP)
    pad = nw * WARP - lanes
    act = torch.cat([active.bool().cpu(), torch.zeros(pad, dtype=torch.bool)])
    act = act.view(nw, WARP).to(words.device)
    s = torch.cat([sel.long().cpu(), torch.zeros(pad, dtype=torch.long)])
    s = s.view(nw, WARP).to(words.device)
    m = act.sum(dim=1)                                   # group sizes [W]
    rank = torch.cumsum(act.long(), dim=1) - 1           # [W, 32]
    # The lane of each rank: active lanes first, in lane order.
    lane_of = torch.argsort((~act).long() * WARP
                            + torch.arange(WARP, device=words.device), dim=1)
    chunks = torch.where(m > 0, -(-n // m.clamp(min=1)), 0)
    out = torch.zeros((nw, WARP, c), dtype=torch.int32, device=words.device)
    for j in range(int(chunks.max()) if nw else 0):
        i0 = (j * m)[:, None]
        rows = (i0 + rank).clamp(0, n - 1)
        read = words[rows]                               # [W, 32, C]
        k = s - i0
        mine = act & (j < chunks)[:, None] & (k >= 0) & (k < m[:, None])
        src = lane_of.gather(1, k.clamp(0, WARP - 1))
        got = read.gather(1, src[..., None].expand(-1, -1, c))
        out = torch.where(mine[..., None], got, out)
    return out.view(nw * WARP, c)[:lanes]


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


def _check_table(table: torch.Tensor) -> None:
    if table.dtype != torch.int32 or table.dim() != 2:
        raise TypeError(f"table must be int32 [N, C], got {table.dtype} "
                        f"{tuple(table.shape)}")
    n, c = table.shape
    if n < 1 or n & (n - 1):
        raise ValueError(f"table rows {n} must be a power of two")
    if not 1 <= c <= MAX_COLS:
        raise ValueError(f"table columns {c} must be in [1, {MAX_COLS}]")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")


def fetch_rows(table: torch.Tensor, sel: torch.Tensor, mode: str = "radix",
               iters: int = 1) -> torch.Tensor:
    """Fetch row ``sel[g]`` of ``table`` (int32 [N, C], N a power of two,
    C <= 16) for every lane ``g`` of ``sel`` (int32 [G], values in [0,
    N)), ``iters`` times with the selection fed back as in
    ``fetch_loop_reference``; returns the last fetch's words as int32
    [C, G].

    CUDA tensors launch ``csrc/fetch.cu`` in ``mode``: "index" (indexed
    loads), "radix" (the warp exchange of ``csrc/fetch.cuh`` that
    ``regen.cu``'s radix route runs, on 32-bit words; ``exchange_reference``
    is its walk), "radix16" (the same exchange keeping two 16-bit halves
    per register, selected with ``__byte_perm``) or "onehot" (the
    ``fetch_planes`` prepass, then the planes times a one-hot matrix on the
    tensor cores, ``wgmma`` bf16 with f32 accumulation); CPU tensors run
    ``fetch_loop_reference``."""
    if mode not in MODES:
        raise ValueError(f"unknown fetch mode {mode!r}")
    _check_table(table)
    if sel.dtype != torch.int32 or sel.dim() != 1 or sel.numel() == 0:
        raise TypeError("sel must be a non-empty int32 [G] tensor")
    if sel.device != table.device:
        raise ValueError(f"sel is on {sel.device}, table on {table.device}")
    if not sel.is_contiguous():
        raise ValueError("sel must be contiguous")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    if table.device.type == "cuda":
        return _launch_fetch_cuda(table, sel, mode, iters)
    if table.device.type != "cpu":
        raise ValueError(f"unsupported device {table.device}")
    return fetch_loop_reference(table, sel, mode, iters)


def fetch_planes(table: torch.Tensor) -> torch.Tensor:
    """The one-hot mode's planes of ``table`` (int32 [N, C], N a power of
    two, C <= 16) as the prepass writes them: int16 [K * N_planes] in
    ``plane_tiles_reference``'s layout. CUDA tensors launch
    ``csrc/fetch.cu``'s prepass; CPU tensors run the plain version."""
    _check_table(table)
    if table.device.type == "cpu":
        return plane_tiles_reference(plane_table_reference(table))
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    from . import _build

    n, c = table.shape
    k_pad, width = plane_shape(n, c)
    planes = torch.empty(k_pad * width, dtype=torch.int16, device=table.device)
    _build.launch("fetch", "rt_fetch_planes_launch", table.device,
                  table.data_ptr(), n, c, planes.data_ptr(),
                  count="fetch_planes")
    return planes


def _launch_fetch_cuda(table, sel, mode, iters):
    from . import _build

    n, c = table.shape
    # The radix modes read rows of a multiple of 4 words as 16-byte
    # vectors, of 2 words as 8-byte ones (load_row); the others read words.
    align = 16 if c % 4 == 0 else 8 if c % 2 == 0 else 4
    if mode in ("radix", "radix16") and table.data_ptr() % align:
        raise ValueError(f"table of {c} columns must be {align}-byte aligned "
                         f"(its data_ptr() % {align} is "
                         f"{table.data_ptr() % align})")
    g = sel.numel()
    planes = fetch_planes(table) if mode == "onehot" else None
    out = torch.empty((c, g), dtype=torch.int32, device=table.device)
    _build.launch("fetch", "rt_fetch_launch", table.device,
                  table.data_ptr(), n, c, sel.data_ptr(), g, out.data_ptr(),
                  _MODE_IDS[mode], iters,
                  None if planes is None else planes.data_ptr(),
                  count=f"fetch_{mode}")
    return out
