"""Named host spans of the program, recorded while a torch profiler records.

`span(name)` is `torch.profiler.record_function(name)` while a profiler is
recording (`torch.autograd._profiler_enabled()`), and one shared null
context otherwise: a span costs one gated call when nothing traces, and
nothing turns it on but a profiler (`train()`'s `--profile_start`, or any
caller's `torch.profiler.profile`).  The profiler keeps the spans in memory
and its Chrome trace puts them and the device's kernels on one clock, so a
kernel is put down to the spans open when the host launched it.

The spans, each where it is opened and what it covers:

    `train_step`              `train/loop.py` `make_train_step` `step()`: the whole step, from the
                              host's side
    `train_step.batch`        the same step: `sample_ray_batch` and the four seed words
    `render.march`            `core/renderer.py` `render_packed` and `render_dense`: the dense or
                              skip march, jitter, contraction, occupancy query, `compact` and the
                              gather of positions
    `render.field`            the same: the field on the packed (or dense) samples (the occupancy
                              sweep's `sigma_fn` is outside it)
    `field.hash_encode`       `models/hashgrid.py` `apply_pieces`: the hash grid's lookup of every
                              level (`ops/hashgrid.py` `hash_lookup`, its forward)
    `render.decode`           the same: sigma decoder, the gather of step sizes, weights, rgb
                              decoder, per-ray sums and compositing
    `train_step.loss`         the step: per-ray MSE, its masked sum, TV and L1, the stack of the
                              pieces the group sums
    `train_step.backward`     the step: `torch.autograd.grad` and the zero fill of unused leaves
    `field.table_grad`        `ops/interp.py`: the backward of `_MultiProj`, `_QuadLookup`,
                              `_CornerLookup` and `_TrilinearOct`; `ops/hashgrid.py`: the backward
                              of `_HashLookup` (on the autograd engine's thread on a card)
    `train_step.adam`         the step: `FusedAdam.step`
    `train_step.all_reduce`   the step, over a process group only: each collective of the loss
                              pieces and of the gradients
    `occupancy.sweep`         `make_occupancy_update`: the sweep of the rank's slab, and its gather
    `occupancy.skip_grid`     `NerfRenderer.skip_grid`: the skip-grid build
    `train.readback`          `BucketEstimator.observe` and `MarchPolicy.observe` when they read,
                              `train()`'s `flush_pending`
    `serve.view`              `train/loop.py` `infer`, once per image: the whole image
    `serve.upload`            `infer`: the image's rays to the device, and their padding
    `serve.enqueue`           `infer`: queueing every chunk (packed or dense)
    `serve.readback`          `infer`, once per packed chunk: its flag and count reads
    `serve.fallback`          `infer`: gathering the flagged rays and re-rendering them densely
    `serve.image`             `infer`: the image copied to the host
"""

from __future__ import annotations

import contextlib
import re

import torch

NAMES = tuple(re.findall(r"^    `([a-z_.]+)`", __doc__, flags=re.MULTILINE))

_NULL = contextlib.nullcontext()


def span(name: str):
    """The span `name` while a torch profiler records, else a shared null
    context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL
