"""Reading ``cuobjdump -sass`` listings of the port's built kernels.

``cuobjdump()`` finds the tool beside nvcc; ``functions(listing)`` splits
a listing into its functions' instructions, as (address, text) with the
predicate left out and local labels resolved to addresses;
``backward_branches(insns)`` gives each loop as (first, last) address
(a branch back to an address at or before its own); ``opcode(text)``
names an instruction for a count; ``global_accesses(listing)`` counts
each function's global loads and stores by width, and
``accesses_by_mode(library, mode_of, modes)`` sums them by a kernel's mode.
``tools/probe_dtype.py`` (the rate loops), ``tools/probe_sweep.py`` (the
sphere and triangle sweeps' loops), ``tools/probe_divide.py`` and
``tools/probe_features.py`` (the access widths) and ``chip_smoke.py`` (the
fetch library) read their SASS through it.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_PRED = re.compile(r"^@!?U?P[T0-9]+\s+")
_BRA = re.compile(r"^BRA(?:\.\S+)?\s+(?:!?U?P[T0-9]+\s*,\s*)?(?:`\()?"
                  r"(0x[0-9a-f]+)")


def cuobjdump() -> str | None:
    """The ``cuobjdump`` beside nvcc, or None."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    home = (os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
            or "/usr/local/cuda")
    cand = os.path.join(home, "bin", "cuobjdump")
    return cand if os.path.exists(cand) else None


def disassemble(tool: str, library) -> str:
    """``cuobjdump -sass`` of a built library."""
    return subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def functions(listing: str) -> dict[str, list[tuple[int, str]]]:
    """Per function of a listing, its instructions as (address, text
    without predicate); a local label in a text becomes its address."""
    funcs: dict[str, list[tuple[int, str]]] = {}
    labels: dict[str, dict[str, int]] = {}
    name, pending = None, []
    for line in listing.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            name = m.group(1)
            funcs[name], labels[name], pending = [], {}, []
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if name is not None and m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if name is not None and m:
            addr = int(m.group(1), 16)
            labels[name].update({lb: addr for lb in pending})
            pending = []
            funcs[name].append((addr, _PRED.sub("", m.group(2))))

    def resolve(lab, text):
        return re.sub(r"\.L_x_\d+", lambda m: hex(lab[m.group(0)])
                      if m.group(0) in lab else m.group(0), text)

    return {f: [(a, resolve(labels[f], t)) for a, t in insns]
            for f, insns in funcs.items()}


def backward_branches(insns: list[tuple[int, str]],
                      uniform: bool = True) -> list[tuple[int, int]]:
    """Each branch back to an address at or before its own, as (target,
    branch address); ``uniform=False`` leaves out ``BRA.U`` and other
    branches with modifiers or a uniform predicate operand."""
    out = []
    for addr, text in insns:
        m = _BRA.match(text)
        if m is None or (not uniform and not re.match(r"BRA\s", text)):
            continue
        target = int(m.group(1), 16)
        if target <= addr:
            out.append((target, addr))
    return out


def opcode(text: str) -> str:
    """An instruction's name for a count: the base name (``FADD``,
    ``ISETP``; ``MUFU.RSQ`` keeps its function), shared and global loads
    with their width (``LDS``, ``LDS.128``)."""
    op = text.split()[0]
    parts = op.split(".")
    if parts[0] in ("LDS", "LDG"):
        width = [p for p in parts[1:] if p.isdigit()]
        return parts[0] + ("." + width[0] if width else "")
    if parts[0] == "MUFU":
        return ".".join(parts[:2])
    return parts[0]


def global_accesses(listing: str) -> dict[str, dict[str, int]]:
    """Per function of a listing, its global loads and stores by width in
    bits (``LDG.E.U16`` is ``LDG.16``, ``LDG.E.128`` ``LDG.128``; 32
    where the instruction names none), counted over the whole function."""
    out = {}
    for fname, insns in functions(listing).items():
        counts: dict[str, int] = {}
        for _, text in insns:
            parts = text.split()[0].split(".")
            if parts[0] not in ("LDG", "STG"):
                continue
            width = [p.lstrip("US") for p in parts[1:]
                     if p.lstrip("US").isdigit()] or ["32"]
            key = f"{parts[0]}.{width[0]}"
            counts[key] = counts.get(key, 0) + 1
        out[fname] = dict(sorted(counts.items()))
    return out


def accesses_by_mode(library, mode_of, modes) -> dict:
    """Each mode's global loads and stores by width in a built library,
    summed over the functions ``mode_of(name)`` maps to it (None leaves a
    function out): ``{"available": True, "modes": {mode: counts}}``, one
    entry per name of ``modes``, or ``{"available": False, "why": ...}``
    without ``cuobjdump``."""
    tool = cuobjdump()
    if tool is None:
        return {"available": False, "why": "cuobjdump not found"}
    out = {"available": True, "modes": {m: {} for m in modes}}
    for fname, counts in global_accesses(disassemble(tool, library)).items():
        mode = mode_of(fname)
        if mode is None:
            continue
        row = out["modes"][mode]
        for key, n in counts.items():
            row[key] = row.get(key, 0) + n
    return out
