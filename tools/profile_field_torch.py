#!/usr/bin/env python3
"""The field's forward and backward pieces at the training cap, timed one
by one (tinynerf_tpu_torch): the port's counterpart of
`tools/profile_field.py`.

    python3 tools/profile_field_torch.py [--method kplanes|cobafa] [--cap 819200] [--n 10]
        [--lookup fused|quad|mixed|plain (K-Planes) | auto|quad|mixed|plain (Cobafa)]
        [--fwd-mode perscale|fusedfine] [--gather-dtype bfloat16|float8|float32] [--pad 0.0] [--device cpu]

`profile_step_torch.py` splits the step into stages; this splits the
largest of them, the field's forward and backward, into its operations, in
the JAX tool's order, on `--cap` points drawn uniformly in [-1, 1]^3 and a
normal cotangent (numpy `default_rng(0)`, as the JAX tool draws them), with
the full-width field of seeded random parameters.  `--pad` makes that share
of the points the packed buffer's pad tail (every pad at point 0, with a
zero cotangent), the cells a converged step's backward sees.

  * K-Planes (planes 129/257/513 x 3 x 32, `--gather-dtype`, default the
    field's bfloat16), in the fused lookup (the default): the nine quad
    builds (kernel 7) and build + gather (`ops/interp.py:
    _quad_lookup_fwd_value`), or with `--fwd-mode fusedfine` the three fused
    fine tables (`fused_fine_table`'s upsampling and kernel 7) and their
    gathers; the `_cell_2d` recompute; the contribution w x g of one
    projection, and `pack_payload` of the three (`ops/table_grad.py`);
    `sort_by_window` (kernel 4); the permutation gather of the packed rows;
    `windowed_accumulate` (kernel 5); `_fine_from_quad`;
    `_pullback_scales`; the whole `_MultiProj.backward`.  In `--lookup`
    quad, the nine quad builds; in mixed and plain, the field alone.
  * Cobafa (basis grids 32..128^3, coefficients 64^3 x 6, bf16 corners):
    the oct build (kernel 6) per grid and for all grids; all grids'
    gathers; the backward of all grids, whole (`_TrilinearOct.backward`'s
    steps: `ops/interp.py: oct_table_grad`, then `oct_fold`) and piece by
    piece: the `_cell_3d` recompute, the window sort (kernel 4),
    `oct_accumulate` (its permutation read) and `oct_fold`; and, run here
    only, the two forms it replaced: the `index_add_` of [n, 8F] rows and
    the payload route of the register kernel's flat layout (pack, sorted
    copy, `windowed_accumulate` in windows of 64 cells on the card), each
    with the eight shifted adds (all three held to 1e-5 of the largest
    gradient); in `--lookup` mixed and plain, the field alone.

Every layout ends with the field's forward (`field fwd`), its backward
alone (`field bwd`, autograd of one forward's graph, kept), and both (for
Cobafa with dropout on), on bf16 compute.
Left out, as TPU layouts the port does not carry: `scatter_add_rows` alone
and the oct build's stack A/B form.  Each piece
prints its ms per call (CUDA events over `--n` calls after one warm-up;
host clock on the CPU), its device time per call (the profiler's kernel
times over max(`--n`, 10) more calls; "not measured" on the CPU or where
the profiler recorded no kernel) and the launches
of each of the port's kernels per call (`ops/cuda_lib.py`'s counters).
`main(argv)` returns the pieces.  Runs on the card unless `--device cpu`
is given.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


# calls under the profiler at the least: windows of a few short kernels
# have come back without any
PROFILED_CALLS = 10


def make_timer(device, n: int, pieces: dict):
    """timeit(name, fn) -> fn's last output, recording the piece."""
    import torch

    from tinynerf_tpu_torch.ops import cuda_lib
    from tinynerf_tpu_torch.utils.device import synchronize

    def device_ms(fn):
        from torch.profiler import ProfilerActivity, profile

        kind = torch.autograd.DeviceType.CUDA
        runs = max(n, PROFILED_CALLS)
        for _ in range(3):  # a window has come back without kernels; take it again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(runs):
                    fn()
                torch.cuda.synchronize()
            total = sum(ev.self_device_time_total for ev in prof.key_averages()
                        if ev.device_type == kind and ev.self_device_time_total > 0)
            if total > 0:
                return total / 1e3 / runs
        return None

    def timeit(name, fn):
        out = fn()  # warm-up
        synchronize(device)
        before = cuda_lib.launch_counts()
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                out = fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / n
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                out = fn()
            ms = (time.perf_counter() - t0) / n * 1e3
        per_call = {k: v / n for k, v in cuda_lib.launches_since(before).items() if v}
        dev_ms = device_ms(fn) if device.type == "cuda" else None
        pieces[name] = {"ms": ms, "device_ms": dev_ms, "launches_per_call": per_call}
        shown = f"{dev_ms:9.3f} ms" if dev_ms is not None else " not measured"
        print(f"{name:58s} {ms:9.3f} ms  device {shown}  launches/call {per_call}", flush=True)
        return out

    return timeit


def _points(cap: int, f_dim: int, pad: float, device):
    """(x [cap, 3], g [cap, f_dim]) as the JAX tool draws them; the last
    `pad` share of the points are pads: point 0, zero cotangent."""
    import torch

    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=(cap, 3)).astype(np.float32)
    g = rng.normal(size=(cap, f_dim)).astype(np.float32)
    n_pad = int(round(pad * cap))
    if n_pad:
        x[cap - n_pad :] = x[0]
        g[cap - n_pad :] = 0.0
    return torch.from_numpy(x).to(device), torch.from_numpy(g).to(device)


def time_field(field, x, timeit, **kw) -> None:
    """The field's forward, its backward alone (autograd of one forward's
    graph, kept) and both, on bf16 compute; `kw` to the field's call."""
    import torch

    params = list(field.parameters())
    loss = lambda: (field(x, torch.bfloat16, **kw).float() ** 2).sum()
    timeit("field fwd", lambda: field(x, torch.bfloat16, **kw))
    graph = loss()
    timeit("field bwd", lambda: torch.autograd.grad(graph, params, retain_graph=True))
    del graph
    timeit("field fwd+bwd (incl product rule)" if "dropout_seed" not in kw else "field fwd+bwd (dropout on)",
           lambda: torch.autograd.grad(loss(), params))


def profile_kplanes(args, device, timeit) -> dict:
    import torch

    from tinynerf_tpu_torch.models import make_model
    from tinynerf_tpu_torch.models.kplanes import DIMENSION_PAIRS, GATHER_DTYPES
    from tinynerf_tpu_torch.ops import interp as I
    from tinynerf_tpu_torch.ops import table_grad as TG
    from tinynerf_tpu_torch.ops.octbuild import build_quad

    lookup = args.lookup or "fused"
    field = make_model("kplanes", field_scale=args.field_scale, generator=torch.Generator().manual_seed(0),
                       device=device, gather_dtype=args.gather_dtype, lookup_mode=lookup, fwd_mode=args.fwd_mode)[0]
    gd = GATHER_DTYPES[args.gather_dtype]
    n_scales, cap = len(field.resolutions), args.cap
    r_fine, f_tot = max(field.resolutions), field.feature_dim
    n_cells = (r_fine - 1) ** 2
    x, g = _points(cap, f_tot, args.pad, device)
    tables = [[field.planes[s][p].detach() for s in range(n_scales)] for p in range(len(DIMENSION_PAIRS))]
    coords = [x[:, [i, j]].contiguous() for i, j in DIMENSION_PAIRS]
    print(f"kplanes: cap={cap} f_tot={f_tot} r_fine={r_fine} gather={args.gather_dtype} lookup={lookup} "
          f"fwd_mode={args.fwd_mode} pad={args.pad}", flush=True)
    extra = {"lookup": lookup, "fwd_mode": args.fwd_mode}

    # ---- forward pieces
    if lookup in ("fused", "quad") and args.fwd_mode == "perscale":
        timeit("fwd: quad builds (x3 proj, kernel 7)", lambda: [build_quad(t, gd) for ts in tables for t in ts])
        timeit("fwd: full value (build+gather, x3)",
               lambda: [I._quad_lookup_fwd_value(t, c, gd) for ts, c in zip(tables, coords) for t in ts])
    elif lookup == "fused":
        timeit("fwd: fused fine tables (x3 proj: upsampling + kernel 7)",
               lambda: [build_quad(I.fused_fine_table(ts, gd), gd) for ts in tables])
        timeit("fwd: full value (fused fine, x3)",
               lambda: [I._fused_fine_pieces(ts, c, gd) for ts, c in zip(tables, coords)])

    # ---- backward pieces, as _MultiProj.backward takes them
    if lookup == "fused":
        cw = timeit("bwd: _cell_2d x3 (recompute)", lambda: [I._cell_2d(c, r_fine, r_fine) for c in coords])
        cells = torch.stack([c.reshape(cap) for c, _ in cw])
        ws = torch.stack([w.reshape(cap, 4) for _, w in cw])
        gs = torch.stack([g] * len(coords))
        timeit("bwd: contrib build (w x g, 1 proj)",
               lambda: (ws[0][:, :, None] * g[:, None, :]).reshape(cap, 4 * f_tot))
        impl = I._resolve_bwd_impl(field.bwd_impl, device, n_cells, cap)
        payload = torch.bfloat16 if impl == "sorted_bf16" else torch.float32
        w_window = TG.default_window(device, 4 * f_tot)
        n_cells_pad = -(-n_cells // w_window) * w_window
        packed = timeit(f"bwd: pack_payload ({str(payload)[6:]}, x3 proj)",
                        lambda: TG.pack_payload(gs, ws, cells, w_window, payload))
        perm, offsets = timeit(f"bwd: sort_by_window (x3 proj, kernel 4; windows of {w_window})",
                               lambda: TG.sort_by_window(cells, n_cells_pad, w_window))
        fp = packed.shape[-1]
        gidx = (perm.long() + (torch.arange(len(coords), device=device) * cap)[:, None]).reshape(-1)
        packed_s = timeit("bwd: permutation gather of the payload (x3 proj)",
                          lambda: packed.reshape(-1, fp).index_select(0, gidx)).reshape(len(coords), cap, fp)
        gq = timeit("bwd: windowed_accumulate (x3 proj, kernel 5)",
                    lambda: TG.windowed_accumulate(packed_s, offsets, f_tot, 4, n_cells_pad, w_window))
        gq0 = gq[0, :n_cells]
        fine = timeit("bwd: _fine_from_quad (1 proj)", lambda: I._fine_from_quad(gq0, r_fine, f_tot))
        timeit("bwd: _pullback_scales (1 proj)", lambda: I._pullback_scales(fine, tables[0]))
        f_plane = field.feature_dim_per_plane
        grads = [g[:, s * f_plane : (s + 1) * f_plane] for _ in coords for s in range(n_scales)]
        ctx = SimpleNamespace(saved_tensors=(*coords, *(t for ts in tables for t in ts)),
                              meta=(field.bwd_impl, None, len(coords), n_scales))
        timeit(f"bwd: whole _MultiProj.backward (x3 proj, {impl})", lambda: I._MultiProj.backward(ctx, *grads))
        del cw, cells, ws, gs, packed, perm, offsets, packed_s, gq, gq0, fine, ctx
        extra.update(bwd_impl=impl, w_window=w_window)

    # ---- the field's forward, backward and both (the product of the projections)
    time_field(field, x, timeit)
    return extra


def profile_cobafa(args, device, timeit) -> dict:
    import torch

    from tinynerf_tpu_torch.models import make_model
    from tinynerf_tpu_torch.models.cobafa import GATHER_DTYPE
    from tinynerf_tpu_torch.ops import interp as I
    from tinynerf_tpu_torch.ops import table_grad as TG
    from tinynerf_tpu_torch.ops.octbuild import build_oct, oct_fold, oct_fold_plain

    lookup = args.lookup or "auto"
    field = make_model("cobafa", field_scale=args.field_scale, generator=torch.Generator().manual_seed(0),
                       device=device, lookup_mode=lookup)[0]
    gd, cap = GATHER_DTYPE, args.cap
    x, _ = _points(cap, 1, args.pad, device)
    n_pad = int(round(args.pad * cap))
    print(f"cobafa: cap={cap} basis_res={field.basis_res} channels={field.channels} "
          f"coef_res={field.coef_res} lookup={lookup} pad={args.pad}", flush=True)
    words = torch.tensor([0x12345678, 0x9ABCDEF0], dtype=torch.int64, device=device)
    if lookup in ("mixed", "plain"):  # the oct pieces below are the oct layout's
        time_field(field, x, timeit, dropout_seed=words)
        return {"lookup": lookup}
    grids = [("coef", field.coef.detach())] + [
        (f"basis{i}(r={b.shape[0]},c={b.shape[-1]})", b.detach()) for i, b in enumerate(field.basis)]
    for name, grid in grids:
        timeit(f"oct build: {name} (kernel 6)", lambda grid=grid: build_oct(grid, gd))
    octs = timeit("oct build: ALL grids", lambda: [build_oct(grid, gd) for _, grid in grids])

    def all_gathers():
        outs = []
        for (_, grid), oct_t in zip(grids, octs):
            r0, r1, r2, f = grid.shape
            cell, w = I._cell_3d(x, r0, r1, r2)
            rows = oct_t[cell].float().reshape(cap, 8, f)
            outs.append(torch.sum(rows * w[..., None], dim=-2))
        return outs

    timeit("gathers: ALL grids (same coords)", all_gathers)
    del octs

    # the backward of every grid for a cotangent of ones (the JAX tool's),
    # zero on the pads: the oct cell gradient, then the fold onto the grid
    g_ones = torch.ones(cap, 1, device=device)
    if n_pad:
        g_ones[cap - n_pad :] = 0.0
    shapes = [tuple(grid.shape) for _, grid in grids]
    n_cells = [(r0 - 1) * (r1 - 1) * (r2 - 1) for r0, r1, r2, _ in shapes]
    gs = [g_ones.expand(cap, s[3]).contiguous() for s in shapes]

    def all_bwd(route: str):
        outs = []
        for shape, nc, g in zip(shapes, n_cells, gs):
            cell, w = I._cell_3d(x, *shape[:3])
            if route == "sorted":
                outs.append(oct_fold(I.oct_table_grad(g, w, cell, nc), shape))
                continue
            if route == "index_add":
                contrib = (g[:, None, :] * w[:, :, None]).reshape(cap, 8 * shape[3])
                gq = torch.zeros(nc, 8 * shape[3], device=device).index_add_(0, cell, contrib)
            else:  # the payload route, windows of 64 cells on the card (256 on the CPU)
                w_window = 64 if device.type == "cuda" else 256
                gq = TG.table_grad_sorted(g[None], w[None], cell[None], nc, w_window, torch.float32, row_align=4)[0]
            outs.append(oct_fold_plain(gq, shape))
        return outs

    new = timeit("bwd: window sort + accumulate + reduce ALL grids", lambda: all_bwd("sorted"))
    cws = timeit("bwd: _cell_3d ALL grids (recompute)", lambda: [I._cell_3d(x, *s[:3]) for s in shapes])
    cells = [c.to(torch.int32).reshape(1, cap) for c, _ in cws]
    pads = [-(-nc // TG.OCT_WINDOW) * TG.OCT_WINDOW for nc in n_cells]
    sorts = timeit(f"bwd: window sort ALL grids (kernel 4; windows of {TG.OCT_WINDOW})",
                   lambda: [TG.sort_windows(c, p, TG.OCT_WINDOW) for c, p in zip(cells, pads)])
    args = list(zip(gs, cws, cells, sorts, pads, n_cells))

    def accumulate(g, cw, c, sort, pad, nc):
        return TG.oct_accumulate(g, cw[1], c[0], sort[0][0], sort[1][0], pad, TG.OCT_WINDOW)[:nc]

    # each grid's cell table dropped as the next is made, as the backward does
    timeit("bwd: oct_accumulate ALL grids (permutation read)", lambda: [accumulate(*a).shape for a in args])
    gqs = [accumulate(*a) for a in args]
    timeit("bwd: oct_fold ALL grids", lambda: [oct_fold(gq, s) for gq, s in zip(gqs, shapes)])
    del cws, cells, sorts, args, gqs
    old = timeit("bwd: index_add_ + reduce ALL grids (replaced; here only)", lambda: all_bwd("index_add"))
    payload = timeit("bwd: payload + flat layout + reduce ALL grids (replaced; here only)",
                     lambda: all_bwd("payload"))
    err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
              for ref in (old, payload) for a, b in zip(new, ref))
    print(f"bwd: sorted vs index_add_ and the payload route, max|diff| / max|ref| over the grids = {err:.3e} "
          f"(tol 1e-5)")
    if not err <= 1e-5:
        raise AssertionError(f"profile_field_torch: the sorted oct gradient disagrees with index_add_ ({err})")
    del new, old, payload

    time_field(field, x, timeit, dropout_seed=words)
    return {"lookup": lookup, "bwd_sorted_vs_index_add": err}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="kplanes", choices=["kplanes", "cobafa"])
    ap.add_argument("--cap", type=int, default=819_200)
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--gather-dtype", dest="gather_dtype", default="bfloat16",
                    choices=["bfloat16", "float8", "float32"], help="K-Planes' quad tables")
    ap.add_argument("--lookup", default=None, choices=[None, "fused", "auto", "quad", "mixed", "plain"],
                    help="the field's lookup_mode (default: the field's, fused / auto)")
    ap.add_argument("--fwd-mode", dest="fwd_mode", default="perscale", choices=["perscale", "fusedfine"],
                    help="K-Planes' fused forward")
    ap.add_argument("--pad", type=float, default=0.0, help="share of the points that are pads")
    ap.add_argument("--field_scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from tinynerf_tpu_torch.utils.device import card_line, resolve_device

    device = resolve_device(args.device, "profile_field_torch")
    card = card_line(device)
    print(f"card: {card}", flush=True)
    pieces = {}
    timeit = make_timer(device, args.n, pieces)
    extra = (profile_kplanes if args.method == "kplanes" else profile_cobafa)(args, device, timeit)
    return {"card": card, "method": args.method, "cap": args.cap, "pad": args.pad, "pieces": pieces, **extra}


if __name__ == "__main__":
    main()
