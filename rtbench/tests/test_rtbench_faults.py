"""Runs of tiny cells on the program's plain versions (the look for a card
skipped), sound and with the timed path broken underneath: ``correct``
holds for the sound runs and comes out false for each fault a cell can
have (a step that returns its state unchanged; half of the batch left
out, the mean taken over the rest; an answer altered where it is
produced). One chip: no exchange between chips to leave out. Without a
card, a run refuses to measure."""

import numpy as np
import pytest
import torch

import raytracing_tpu_torch.ops.trace as ptrace
from raytracing_tpu_torch.runtime.renderer import Renderer
from rtbench import run
from rtbench.tests.tiny import CELLS, tiny_cell

SEED = 2**31 + 977


def _run(name):
    code, result = run.run_cell(tiny_cell(name), SEED, 0.3, False,
                                device="cpu", log=lambda m: None)
    assert code == 0
    return result


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = _run(name)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0


def _stale(orig):
    first = {}

    def f(*a, **k):
        out = orig(*a, **k)
        return first.setdefault("v", out)
    return f


def _render_half(orig):
    def f(self, spp=None, max_depth=None, **k):
        return orig(self, spp=max(1, spp // 2), max_depth=max_depth, **k)
    return f


def _render_altered(orig):
    def f(*a, **k):
        img = orig(*a, **k).copy()
        img[..., 0] = np.minimum(img[..., 0].astype(np.int32) + 1, 255)
        return img
    return f


def _trace_half(orig):
    def f(tables, o, d, seed, off, depth, tile_rays=1024, **k):
        half = (o.shape[0] // 2 // tile_rays) * tile_rays
        rad, seg = orig(tables, o[:half].contiguous(), d[:half].contiguous(),
                        seed, off, depth, tile_rays=tile_rays, **k)
        out = torch.zeros_like(o)
        out[:half] = rad
        return out, seg
    return f


def _trace_altered(orig):
    def f(*a, **k):
        rad, seg = orig(*a, **k)
        return rad * 1.01, seg
    return f


def _frame_half(orig):
    def f(self, spp=None, *a, **k):
        return orig(self, max(1, spp // 2), *a, **k)
    return f


def _frame_altered(orig):
    def f(*a, **k):
        u8, prev, total = orig(*a, **k)
        return u8, torch.clamp(prev.int() + 1, max=255).to(torch.uint8), total
    return f


FAULTS = {
    "cover.north_star": (Renderer, "render",
                         [_stale, _render_half, _render_altered]),
    "mesh3.render": (Renderer, "render",
                     [_stale, _render_half, _render_altered]),
    "mesh3.rays": (ptrace, "trace_rays_fused",
                   [_stale, _trace_half, _trace_altered]),
    "cover.orbit": (Renderer, "render_frame_accum_preview",
                    [_stale, _frame_half, _frame_altered]),
}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    owner, attr, makers = FAULTS[name]
    make = makers[["unchanged", "half", "altered"].index(fault)]
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    result = _run(name)
    assert not result["correct"], result["checks"]


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, result = run.run_cell(tiny_cell("cover.north_star"), SEED, 0.3,
                                False, log=lambda m: None)
    assert (code, result) == (2, None)
