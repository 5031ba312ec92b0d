"""Toolchain watch for the card: fingerprint torch, CUDA, nvcc, the driver
and the card, and re-probe the features the JAX package's watcher tracks.

The Hopper counterpart of the JAX package's ``scripts/toolchain_watch.py``.
It writes the port's own ledger (by default
``raytracing_tpu_torch/tools/toolchain_ledger.json``, ``--ledger PATH``
elsewhere), never the JAX package's ``TOOLCHAIN.json``.

* ``--check`` (the default): compare ``fingerprint()`` with the ledger's
  last entry; exit 0 when unchanged, 2 when it changed (or the ledger is
  empty): run ``--probes``.
* ``--probes``: run every probe, each in its own child process with a
  timeout (600 s; four at a time), and append the fingerprint and the
  statuses to the ledger. ``--probe NAME`` runs one and appends it too.
  ``--run-probe NAME`` is the child's own entry: it runs the probe in
  process and prints one JSON line ``{"status", "detail", "launches"}``
  (the kernel launches it made, by launch counter).

Statuses: ``works`` (the kernel equals its plain version bit for bit, and
the plain version equals the JAX probe's own expectation, computed with
numpy as that probe computes it), ``wrong`` (it ran and differs),
``blocked`` (an error: the first line is kept), ``timeout``.

The probes:

* the four feature kernels (``csrc/features.cu``) on the JAX probes' own
  inputs: ``bf16_vector_cmp``, ``i16_mask_relayout``, ``i16_hoisted_mask``
  (the JAX check of this one is vacuous; here the values are compared) and
  ``dynamic_gather``;
* ``tri_blk_512``: ``mesh:3`` at 128 px @ 2, depth 3, rendered with
  ``RT_TRI_BLK=512`` and without it, byte-equal (the port validates that
  knob and ignores it);
* ``hash_paths``: ``mesh:3`` at 320 px @ 2, depth 8, seed 1, on the
  default fetch route and under ``RT_GATHER=radix RT_TWO_LEVEL_MXU=0``,
  image sha256s equal (the JAX watcher's ``run_hw_hash_paths``);
* the other probe kernels against their plain versions at small shapes:
  ``segment_split`` (every variant, both cameras, 2,048 slots, 8 steps),
  ``worklist`` (every mode, pass fractions 1/8 and 8/8, 3 units, 3
  passes), ``divide`` (ieee and rn bit-equal on the probe's inputs and the
  edge set, fast and approx within 2 ulp) and ``dtype`` (the bitcast and
  every rate mode at 4 and 16 steps, the JAX inputs and seeded tiles on 2
  units).

``--device cpu`` runs the plain versions in the children (every wrapper
takes its plain version on CPU tensors), for the tests. Without it the
tool needs a card and exits 1 when CUDA is not available.

Usage (on the card)::

    python -m raytracing_tpu_torch.tools.toolchain_watch --check
    python -m raytracing_tpu_torch.tools.toolchain_watch --probes \
        [--ledger PATH]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import datetime
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build

ROOT = pathlib.Path(__file__).resolve().parents[2]
LEDGER = pathlib.Path(__file__).resolve().with_name("toolchain_ledger.json")
PROBE_TIMEOUT_S = 600.0
PROBE_JOBS = 4  # children at once


def _first_line(cmd: list[str], match: str = "") -> str:
    """The first line of ``cmd``'s output holding ``match``, or "not
    found" where the command is missing or fails."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not found"
    if out.returncode != 0:
        return "not found"
    lines = [ln.strip() for ln in out.stdout.splitlines() if match in ln]
    return lines[0] if lines else "not found"


def _nvcc_release() -> str:
    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        return "not found"
    return _first_line([nvcc, "--version"], "release")


def fingerprint(device: str = "cuda") -> dict:
    """The toolchain and the card: torch and its CUDA, nvcc's release line,
    and on a card the driver, the device's name, compute capability and SM
    count, and ``name, power.limit`` as ``nvidia-smi`` gives them."""
    fp = {"torch": torch.__version__, "torch_cuda": torch.version.cuda,
          "nvcc": _nvcc_release(), "device": device}
    if device == "cuda":
        props = torch.cuda.get_device_properties(0)
        smi = ["nvidia-smi", "--format=csv,noheader"]
        fp.update({
            "driver": _first_line(smi[:1] + ["--query-gpu=driver_version"]
                                  + smi[1:]),
            "device_name": torch.cuda.get_device_name(0),
            "capability": f"{props.major}.{props.minor}",
            "sm_count": props.multi_processor_count,
            "card": _first_line(smi[:1] + ["--query-gpu=name,power.limit"]
                                + smi[1:]),
        })
    return fp


# ---------------------------------------------------------------- probes
# Each takes the device and returns (status, detail).


def _verdict(checks: dict[str, bool]) -> tuple[str, str]:
    bad = [k for k, ok in checks.items() if not ok]
    return ("works", "") if not bad else ("wrong", "differs: " + ", ".join(bad))


def _jax_expect(mode: str, args: tuple) -> np.ndarray:
    """The JAX probe's own expectation, with numpy, as that probe computes
    it (its bitcast layout written out: f32 row r is int16 rows 2r, 2r+1)."""
    if mode == "bf16_cmp":
        return (args[0].float().numpy() > 0.5).astype(np.float32)
    a = [t.numpy() for t in args]
    if mode == "dyn_gather":
        return np.take_along_axis(a[0], a[1], axis=0)
    x, s = a
    xi = x.view(np.int16).reshape(8, 128, 2)
    ti = np.zeros((16, 128), np.int16)
    ti[0::2], ti[1::2] = xi[:, :, 0], xi[:, :, 1]
    m = s > 0 if mode == "i16_relayout" else ((s >> 1) & 1) > 0
    sel = np.where(m, ti[8:16], ti[0:8])
    expect = np.zeros((4, 128, 2), np.int16)
    expect[:, :, 0], expect[:, :, 1] = sel[0::2], sel[1::2]
    return expect.reshape(4, 256).view(np.float32)


def _feature(mode: str):
    def probe(dev: torch.device) -> tuple[str, str]:
        from ..ops import dtype as rdt
        from ..ops import features as rfeat

        host = rfeat.inputs(mode)
        args = tuple(t.to(dev) for t in host)
        got = rfeat.features(mode, *args)
        plain = rfeat.features_reference(mode, *args)
        want = _jax_expect(mode, host)
        return _verdict({
            "kernel vs plain": rdt.bits_equal(got, plain),
            "plain vs the JAX probe's expectation": rdt.bits_equal(
                plain.cpu(), torch.from_numpy(want)),
        })
    return probe


@contextlib.contextmanager
def _env(**values):
    """Set (a string) or unset (None) environment variables for the block."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _render(scene, params, seed: int, dev: torch.device) -> np.ndarray:
    from ..runtime.renderer import Renderer

    return Renderer(scene, params, seed=seed, device=dev.type).render()


def _probe_tri_blk_512(dev: torch.device) -> tuple[str, str]:
    from ..scene import config as rconfig

    cam0, scene = rconfig.make_world_mesh(image_width=128, subdivisions=3)
    params = dataclasses.replace(cam0, image_width=128, samples_per_pixel=2,
                                 max_depth=3)
    with _env(RT_TRI_BLK=None):
        default = _render(scene, params, 0, dev)
    with _env(RT_TRI_BLK="512"):
        blk = _render(scene, params, 0, dev)
    return _verdict({"RT_TRI_BLK=512 byte-equal to the default":
                     np.array_equal(default, blk),
                     "image not blank": bool(blk.any())})


def _probe_hash_paths(dev: torch.device) -> tuple[str, str]:
    from ..scene import config as rconfig

    cam0, scene = rconfig.make_world_mesh(image_width=320, subdivisions=3)
    params = dataclasses.replace(cam0, aspect_ratio=16.0 / 9.0,
                                 image_width=320, samples_per_pixel=2,
                                 max_depth=8)
    hashes = {}
    for name, bundle in (("default", {}),
                         ("radix", {"RT_GATHER": "radix",
                                    "RT_TWO_LEVEL_MXU": "0"})):
        with _env(RT_GATHER=None, RT_TWO_LEVEL_MXU=None), _env(**bundle):
            img = _render(scene, params, 1, dev)
        hashes[name] = hashlib.sha256(img.tobytes()).hexdigest()[:16]
    status, detail = _verdict({"sha256 equal": len(set(hashes.values())) == 1})
    return status, f"{detail} {hashes}".strip()


def _probe_segment_split(dev: torch.device) -> tuple[str, str]:
    from ..ops import segment_split as rseg
    from . import probe_segment_split

    tables = probe_segment_split.cover_tables(dev)
    checks = {}
    for cam_name, cam in probe_segment_split.cameras().items():
        for v in rseg.VARIANTS:
            kw = dict(seed=7, steps=8, slots=2048, variant=v)
            got = rseg.segment_split(tables, cam, **kw)
            want = rseg.segment_split_reference(tables, cam, **kw)
            checks[f"{v} ({cam_name})"] = (torch.equal(got[0], want[0])
                                           and torch.equal(got[1], want[1]))
    return _verdict(checks)


def _probe_worklist(dev: torch.device) -> tuple[str, str]:
    from ..ops import worklist as rwl

    checks = {}
    for pg in (1, rwl.GROUPS):
        tab, rays, votes = (t.to(dev) for t in rwl.inputs(pg))
        pay = rwl.payloads(rays, 3).contiguous()
        for m in rwl.MODES:
            checks[f"{m} {pg}/8"] = torch.equal(
                rwl.worklist_probe(tab, pay, votes, 3, m),
                rwl.worklist_reference(tab, pay, votes, 3, m))
    return _verdict(checks)


def _probe_divide(dev: torch.device) -> tuple[str, str]:
    from ..ops import divide as rdiv

    checks = {}
    for inputs in (rdiv.inputs, rdiv.edge_inputs):
        x, num = (t.to(dev).contiguous() for t in inputs())
        x64 = x.cpu().numpy().astype(np.float64)
        n64 = num.cpu().numpy().astype(np.float64)
        for mode in rdiv.MODES:
            r, q = rdiv.divide(x, num, mode)
            pr, pq = rdiv.divide_reference(x, num, mode)
            key = f"{mode} ({inputs.__name__})"
            if mode in ("ieee", "rn"):
                checks[key] = torch.equal(r, pr) and torch.equal(q, pq)
            elif inputs is rdiv.inputs:
                checks[key] = max(
                    rdiv.ulp_error(r.cpu().numpy(), 1.0 / x64).max(),
                    rdiv.ulp_error(q.cpu().numpy(), n64 / x64).max()) <= 2.0
    return _verdict(checks)


def _probe_dtype(dev: torch.device) -> tuple[str, str]:
    from ..ops import dtype as rdt

    x = rdt.bitcast_input().to(dev)
    out, halves = rdt.bitcast(x, halves=True)
    pout, phalves = rdt.bitcast_reference(x, halves=True)
    checks = {"bitcast": torch.equal(out, pout)
              and torch.equal(halves, phalves)}
    for mode in rdt.RATE_MODES:
        dt = rdt.mode_dtype(mode)
        jax_tile = tuple(rdt.replicate(t, 2) for t in rdt.inputs(dt))
        seeded = rdt.seeded_inputs(dt, (2, rdt.default_rows(dt), rdt.COLS))
        for name, (a, b) in (("JAX inputs", jax_tile), ("seeded", seeded)):
            a, b = a.to(dev), b.to(dev)
            for iters in (4, 16):
                checks[f"{mode} {name} {iters} steps"] = rdt.bits_equal(
                    rdt.rate(a, b, mode, iters),
                    rdt.rate_reference(a, b, mode, iters))
    return _verdict(checks)


PROBES = {
    "bf16_vector_cmp": _feature("bf16_cmp"),
    "i16_mask_relayout": _feature("i16_relayout"),
    "i16_hoisted_mask": _feature("i16_hoisted"),
    "dynamic_gather": _feature("dyn_gather"),
    "tri_blk_512": _probe_tri_blk_512,
    "hash_paths": _probe_hash_paths,
    "segment_split": _probe_segment_split,
    "worklist": _probe_worklist,
    "divide": _probe_divide,
    "dtype": _probe_dtype,
}


def run_probe(name: str, device: str) -> dict:
    """One probe in this process: its status, detail and the kernel
    launches it made."""
    dev = torch.device(device)
    try:
        status, detail = PROBES[name](dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 -- a probe's error is its status
        lines = [ln for ln in str(e).splitlines() if ln.strip()]
        status = "blocked"
        detail = f"{type(e).__name__}: {lines[0] if lines else ''}"[:300]
    launches = {k: v for k, v in _build.launch_counts.items() if v}
    return {"status": status, "detail": detail, "launches": launches}


def run_probe_subprocess(name: str, device: str,
                         timeout: float = PROBE_TIMEOUT_S) -> dict:
    """``name`` in a child process (``--run-probe``), so that a crash or a
    hang stays there; the child is killed at ``timeout`` seconds."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "raytracing_tpu_torch.tools.toolchain_watch",
           "--run-probe", name, "--device", device]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, env=env, cwd=str(ROOT))
    except subprocess.TimeoutExpired:
        return {"status": "timeout", "detail": f">{timeout:g} s",
                "launches": {}}
    for line in reversed(proc.stdout.strip().splitlines()):
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                break
    tail = (proc.stderr or proc.stdout).strip().splitlines()
    return {"status": "blocked",
            "detail": (tail[-1] if tail else f"exit {proc.returncode}")[:300],
            "launches": {}}


def run_probes(names, device: str) -> dict[str, dict]:
    """Every probe in ``names``, each in its own child, ``PROBE_JOBS`` at
    once."""
    names = list(names)
    with concurrent.futures.ThreadPoolExecutor(PROBE_JOBS) as pool:
        results = pool.map(lambda n: run_probe_subprocess(n, device), names)
        return dict(zip(names, results))


def load_ledger(path: pathlib.Path) -> list:
    if not path.exists():
        return []
    with open(path) as f:
        return json.load(f)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="toolchain_watch", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--check", action="store_true",
                    help="compare the fingerprint with the ledger (default)")
    ap.add_argument("--probes", action="store_true", help="run every probe")
    ap.add_argument("--probe", choices=sorted(PROBES), help="run one probe")
    ap.add_argument("--run-probe", choices=sorted(PROBES),
                    help="run one probe in this process (the child's entry)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ledger", type=pathlib.Path, default=LEDGER)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("toolchain_watch: CUDA is not available; --device cpu runs "
              "the plain versions", file=sys.stderr)
        return 1

    if args.run_probe:
        print(json.dumps(run_probe(args.run_probe, args.device)), flush=True)
        return 0

    fp = fingerprint(args.device)
    ledger = load_ledger(args.ledger)
    changed = not ledger or fp != ledger[-1]["fingerprint"]
    if args.probe or args.probes:
        names = [args.probe] if args.probe else list(PROBES)
        results = run_probes(names, args.device)
        for name, r in results.items():
            print(f"probe {name}: {r['status']} {r['detail']}".rstrip(),
                  flush=True)
        entry = {
            "timestamp": datetime.datetime.now(datetime.timezone.utc)
            .isoformat(timespec="seconds"),
            "fingerprint": fp,
            "probes": results,
        }
        ledger.append(entry)
        args.ledger.parent.mkdir(parents=True, exist_ok=True)
        with open(args.ledger, "w") as f:
            json.dump(ledger, f, indent=1)
            f.write("\n")
        print(json.dumps(entry))
        return 0

    print(json.dumps({"fingerprint": fp, "changed": changed}))
    if changed:
        print("toolchain fingerprint CHANGED (or no ledger entry): run "
              "`python -m raytracing_tpu_torch.tools.toolchain_watch "
              "--probes`", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
