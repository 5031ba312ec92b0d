"""The dtype probe: where each 16-bit half of a 32-bit word lands, and the
rates of chained FMA and select on f32, bf16 and int16.

Counterpart of the JAX package's probe kernels (``scripts/probe_dtype.py``:
``bitcast_probe`` and ``rate_probe``). Modes of the kernel
(``csrc/dtype.cu``):

* ``"bitcast"``: f32 ``[..., R, 128]`` to int16 ``[..., 2R, 128]`` in the
  layout the JAX probe finds in interpret mode: row 2r holds the low
  halves of row r's words, row 2r+1 the high halves. A thread of the
  kernel takes 8 words of a row by two 16-byte loads, splits them with
  ``__byte_perm`` and writes 8 low halves and 8 high halves by one
  16-byte store each (``group_map`` is its index map); an input that is
  only 8-byte aligned takes a body of two words a thread. It also reports
  which half ``__nv_bfloat162.x`` and ``short2.x`` read
  (``bitcast(..., halves=True)``).
* The rate modes, each the JAX kernel's function of its tile: per element,
  8 streams ``s_i = a + (b + b) * i``, then ``iters`` dependent steps of
  each stream, then the streams summed in order (xor'ed for int16):

  - ``"f32_fma"``: ``s * b + s``, rounded once (``__fmaf_rn``; the sources
    build with ``-fmad=false``, so a plain ``s * b + s`` would round
    twice);
  - ``"f32_select"``: ``where(b > 0.5, s, b) + s`` (FSEL, FADD);
  - ``"bf16_fma"``: ``s * b + s`` on ``__nv_bfloat162`` pairs, rounded
    once (``__hfma2``);
  - ``"bf16_select"``: the select on a pair as one bitwise select of the
    word by a mask word (``__hgt2_mask``), then ``__hadd2_rn``;
  - ``"i16_select"``: int16 pairs packed in one 32-bit word: the same
    bitwise select by a mask word (``__vcmpgts2(b, 0)``, the JAX ``b >
    0``) and the add by ``__vadd2`` (wrapping per half).

  Every bf16 add and multiply of the kernel, in the streams' set-up and
  the sum too, rounds once (``__hadd2_rn``, ``__hmul2_rn``). Each thread
  owns one 32-bit word (one f32, or a pair of 16-bit elements), so a
  (rows, 128) tile is 1,024 threads for every dtype at the JAX rows (8 for
  f32, 16 otherwise), and the card is filled by replicating the tile over
  ``units`` (``replicate``).

* ``inputs(dtype, rows)`` makes ``rate_probe``'s ``a`` and ``b``,
  ``seeded_inputs`` random tiles (every mask value, every stream distinct);
* ``bitcast_reference`` and ``rate_reference`` are the plain PyTorch
  versions: ``view(torch.int16)`` and a permute for the bitcast; for the
  rates, f32 FMA through f64 (exact for these inputs, then one rounding),
  bf16 operations through f64 and one rounding to bf16 each (round to odd
  into f32, then to nearest even into bf16: one correct rounding), int16
  in wrapping int16 arithmetic;
* ``bitcast`` and ``rate`` launch the kernel on CUDA tensors (or raise)
  and run the plain version on CPU tensors;
* ``bits_equal`` compares two tensors bit for bit (the kernels' parity
  checks use it).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

RATE_MODES = ("f32_fma", "f32_select", "bf16_fma", "bf16_select",
              "i16_select")
MODES = ("bitcast",) + RATE_MODES
STREAMS = 8
COLS = 128
_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i16": torch.int16}


def mode_dtype(mode: str) -> torch.dtype:
    if mode not in RATE_MODES:
        raise ValueError(f"unknown rate mode {mode!r}")
    return _DTYPES[mode.split("_")[0]]


def default_rows(dtype: torch.dtype) -> int:
    """``rate_probe``'s rows: one f32 vreg (8 rows) or one 16-bit vreg (16)."""
    return 8 if dtype == torch.float32 else 16


def inputs(dtype: torch.dtype, rows: int | None = None):
    """``(a, b)`` of ``rate_probe``: ones for int16, else 0.999 and 0.6 in
    ``dtype``, each ``[rows, 128]``."""
    rows = default_rows(dtype) if rows is None else rows
    if dtype == torch.int16:
        return (torch.ones((rows, COLS), dtype=dtype),
                torch.ones((rows, COLS), dtype=dtype))
    return (torch.full((rows, COLS), 0.999, dtype=dtype),
            torch.full((rows, COLS), 0.6, dtype=dtype))


def seeded_inputs(dtype: torch.dtype, shape, seed: int = 0):
    """Random ``(a, b)`` of ``shape``: floats a in [-2, 2), b in [0.25,
    1.0) (about half over the select's 0.5; every FMA step and sum stays
    exact in f64 before its one rounding); int16 a and b uniform over the
    type (b > 0 about half the time)."""
    rng = np.random.default_rng(seed)
    shape = tuple(shape)
    if dtype == torch.int16:
        a = rng.integers(-(1 << 15), 1 << 15, size=shape, dtype=np.int16)
        b = rng.integers(-(1 << 15), 1 << 15, size=shape, dtype=np.int16)
        return torch.from_numpy(a), torch.from_numpy(b)
    a = rng.uniform(-2.0, 2.0, size=shape).astype(np.float32)
    b = rng.uniform(0.25, 1.0, size=shape).astype(np.float32)
    return (torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype))


def bitcast_input() -> torch.Tensor:
    """``bitcast_probe``'s f32 [8, 128]: word k has high half k, low half 7."""
    x = np.arange(8 * COLS, dtype=np.uint32) * 65536 + 7
    return torch.from_numpy(x.view(np.float32).reshape(8, COLS).copy())


def replicate(t: torch.Tensor, units: int) -> torch.Tensor:
    """``t`` repeated over a leading dimension of ``units``, contiguous."""
    return t.unsqueeze(0).expand(units, *t.shape).contiguous()


# ---------------------------------------------------------------- bitcast
GROUP = 8  # words a thread of the 16-byte body takes


def _check_bitcast(x):
    if x.dtype != torch.float32:
        raise TypeError("x must be float32")
    if x.dim() < 2 or x.shape[-1] != COLS or x.numel() == 0:
        raise ValueError(f"x must be [..., rows, {COLS}]")


def group_map(words: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The 16-byte body's index map over ``words`` f32 words (rows of
    128): per thread g, the first word it loads (8 in a row, two 16-byte
    loads) and the int16 offsets where its low-halves and high-halves
    stores (8 halves each) begin. Thread g takes row g // 16, columns
    8 (g % 16) on; its stores land at those columns of int16 rows 2r and
    2r + 1."""
    g = np.arange(words // GROUP, dtype=np.int64)
    row, col = g // (COLS // GROUP), GROUP * (g % (COLS // GROUP))
    return GROUP * g, 2 * row * COLS + col, (2 * row + 1) * COLS + col


def bitcast_i16(x: torch.Tensor) -> torch.Tensor:
    """32-bit ``[..., R, 128]`` seen as int16 ``[..., 2R, 128]`` in the JAX
    bitcast layout: row 2r the low halves of row r's words, row 2r+1 the
    high halves."""
    h = x.view(torch.int16).unflatten(-1, (COLS, 2)).transpose(-1, -2)
    return h.reshape(*x.shape[:-2], 2 * x.shape[-2], COLS)


def bitcast_reference(x: torch.Tensor, halves: bool = False):
    """int16 ``[..., 2R, 128]`` (``bitcast_i16``). With ``halves``, also
    int32 ``[2]``: the half that the first element of a 16-bit pair reads
    from the first word (the one at the lower address: its low half,
    little-endian)."""
    _check_bitcast(x)
    out = bitcast_i16(x)
    if not halves:
        return out
    first = x.reshape(-1)[:1].view(torch.int16)[0].to(torch.int32) & 0xFFFF
    return out, first.repeat(2)


def bitcast(x: torch.Tensor, halves: bool = False):
    """``bitcast_reference``'s function: CUDA tensors launch
    ``csrc/dtype.cu`` (or raise), CPU tensors run the plain version."""
    _check_bitcast(x)
    if x.device.type == "cuda":
        return _launch_bitcast(x, halves)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return bitcast_reference(x, halves)


# ---------------------------------------------------------------- rates
def _check_rate(a, b, mode, iters):
    dtype = mode_dtype(mode)
    if a.dtype != dtype or b.dtype != dtype:
        raise TypeError(f"{mode}: a and b must be {dtype}")
    if a.shape != b.shape or a.dim() < 2 or a.shape[-1] != COLS:
        raise ValueError(f"a and b must have one shape [..., rows, {COLS}]")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")


def _bf16_round(x64: torch.Tensor) -> torch.Tensor:
    """The exact value ``x64`` rounded once to nearest-even bf16: rounded to
    odd into f32 (truncate, then set the last bit where inexact), then to
    nearest even into bf16, which equals one correct rounding since f32
    keeps 16 bits more than bf16."""
    f = x64.float()
    bits = f.view(torch.int32)
    inexact = f.double() != x64
    over = inexact & (f.double().abs() > x64.abs())
    bits = torch.where(over, bits - 1, bits)
    bits = torch.where(inexact, bits | 1, bits)
    return bits.view(torch.float32).to(torch.bfloat16)


def rate_reference(a: torch.Tensor, b: torch.Tensor, mode: str,
                   iters: int) -> torch.Tensor:
    """Plain PyTorch version of the rate kernel: ``a``'s shape and dtype,
    each element the sum (xor for int16) of its 8 streams after ``iters``
    steps. The 8 streams are one leading dimension."""
    _check_rate(a, b, mode, iters)
    i = torch.arange(STREAMS, device=a.device).view(-1, *([1] * a.dim()))
    op = mode.split("_")[1]
    if a.dtype == torch.int16:
        s = a + (b + b) * i.to(torch.int16)
        mask = b > 0
        for _ in range(iters):
            s = torch.where(mask, s, b) + s
        acc = s[0]
        for k in range(1, STREAMS):
            acc = acc ^ s[k]
        return acc
    if a.dtype == torch.float32:
        s = a + (b + b) * i.float()
        b64 = b.double()
        mask = b > 0.5
        for _ in range(iters):
            if op == "fma":
                s64 = s.double()
                s = (s64 * b64 + s64).float()
            else:
                s = torch.where(mask, s, b) + s
        acc = s[0]
        for k in range(1, STREAMS):
            acc = acc + s[k]
        return acc
    # bf16: every operation exact in f64, then rounded once.
    a64, b64 = a.double(), b.double()
    bb = _bf16_round(b64 + b64).double()
    s = _bf16_round(a64 + _bf16_round(bb * i.double()).double())
    mask = b > 0.5
    for _ in range(iters):
        s64 = s.double()
        if op == "fma":
            s = _bf16_round(s64 * b64 + s64)
        else:
            s = _bf16_round(torch.where(mask, s64, b64) + s64)
    acc = s[0]
    for k in range(1, STREAMS):
        acc = _bf16_round(acc.double() + s[k].double())
    return acc


def rate(a: torch.Tensor, b: torch.Tensor, mode: str,
         iters: int) -> torch.Tensor:
    """``rate_reference``'s function: CUDA tensors launch ``csrc/dtype.cu``
    (one thread a 32-bit word) or raise, CPU tensors run the plain
    version."""
    _check_rate(a, b, mode, iters)
    if a.device.type == "cuda":
        return _launch_rate(a, b, mode, iters)
    if a.device.type != "cpu":
        raise ValueError(f"unsupported device {a.device}")
    return rate_reference(a, b, mode, iters)


def steps_per_body() -> int:
    """Steps of every stream in one body of the rate kernel's main loop
    (``kUnroll`` of the built ``csrc/dtype.cu``): the SASS count divides
    that body by them."""
    return int(_build.load("dtype").rt_dtype_steps_per_body())


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equality of two tensors of one dtype, shape and device, NaN
    patterns included."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def element_steps(numel: int, iters: int) -> int:
    """Stream steps of one call: 8 streams of ``iters`` steps an element."""
    return numel * STREAMS * iters


# ---------------------------------------------------------------- launches
def _launch_bitcast(x, halves):
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.data_ptr() % 8:
        # The kernel reads x in 16-byte groups or 8-byte pairs of words.
        raise ValueError(f"x must be 8-byte aligned (its data_ptr() % 8 is "
                         f"{x.data_ptr() % 8})")
    shape = x.shape
    out = x.new_empty((*shape[:-2], 2 * shape[-2], COLS), dtype=torch.int16)
    hv = x.new_empty(2, dtype=torch.int32) if halves else None
    _build.launch("dtype", "rt_dtype_bitcast_launch", x.device, x.data_ptr(),
                  out.data_ptr(), hv.data_ptr() if halves else None,
                  x.numel(), count="dtype_bitcast")
    return (out, hv) if halves else out


def _launch_rate(a, b, mode, iters):
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    if (a.data_ptr() | b.data_ptr()) % 4:
        # The kernel reads a and b as 32-bit words (a 16-bit pair each).
        raise ValueError("a and b must be 4-byte aligned")
    out = torch.empty_like(a)
    words = a.numel() * a.element_size() // 4
    _build.launch("dtype", "rt_dtype_rate_launch", a.device, a.data_ptr(),
                  b.data_ptr(), out.data_ptr(), words,
                  RATE_MODES.index(mode), iters, count=f"dtype_{mode}")
    return out
