"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have, planted in the program at the tiny size on the CPU
(the card check skipped), judged by the cell's own limits."""

from __future__ import annotations

import pytest
import torch
from conftest import tiny_run

import tinynerf_tpu_torch.train as program_train
from tinynerf_tpu_torch.core.renderer import NerfRenderer
from tinynerf_tpu_torch.train import loop as program_loop

TRAIN = ["kplanes.train.early", "cobafa.train.early"]


@pytest.mark.parametrize("workload", TRAIN + ["kplanes.serve.views"])
def test_sound_run_is_correct(workload):
    assert tiny_run(workload)["correct"]


@pytest.mark.parametrize("workload", TRAIN)
def test_state_left_unchanged(workload, monkeypatch):
    monkeypatch.setattr(program_loop.FusedAdam, "step", lambda self, grads: None)
    assert not tiny_run(workload)["correct"]


@pytest.mark.parametrize("workload", TRAIN)
def test_half_the_batch_left_out(workload, monkeypatch):
    render = NerfRenderer.render_packed

    def half(self, *args, **kw):
        out = render(self, *args, **kw)
        valid = out.ray_valid.clone()
        valid[valid.shape[0] // 2 :] = 0.0  # the mean taken over the rest
        return out._replace(ray_valid=valid)

    monkeypatch.setattr(NerfRenderer, "render_packed", half)
    assert not tiny_run(workload)["correct"]


def test_a_served_pixel_altered(monkeypatch):
    make = program_train.make_render_chunk_packed

    def altered(*args, **kw):
        fn = make(*args, **kw)

        def render(*a):
            rgb, ok, n_samples, n_complete = fn(*a)
            return rgb + torch.nn.functional.one_hot(torch.tensor(0), rgb.shape[0])[:, None] * 0.25, ok, \
                n_samples, n_complete

        return render

    monkeypatch.setattr(program_train, "make_render_chunk_packed", altered)
    assert not tiny_run("kplanes.serve.views")["correct"]
