"""Plain PyTorch reference of what the cells compute: the fixed-capacity
choice of the rays a step trains on, the shared decoders, the transmittance
weights with early termination, compositing, the loss, its gradient by
autograd and Adam, and the helpers that the field and scene files share.

A configuration's field is `fields/<config["field"]["kind"]>.py` (its
parameters, features and extra loss terms) and its scene
`scenes/<config["train"]["scene_type"]>.py` (its march, with the hash
jitter and the occupancy cull); both are found by those names, so a new
kind is a new file.  Written from the methods' published equations and
the tinynerf conventions (align-corners grids, ray-major sample order),
with TF32 off, in a precision `prec`: "f32" is the plain model; "bf16" the
precision the configurations state (table values rounded to bfloat16
before the lerp, every matrix product of bfloat16 inputs summed in
float32, and every layer's output and each feature vector rounded to
bfloat16); "fp8" the same rounding points in float8_e4m3fn, the control
one precision below.  It imports neither JAX nor the program, and takes
from the program nothing but the outputs it judges.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

_M32 = 0xFFFFFFFF
FP8_MAX = 448.0  # the largest finite float8_e4m3fn
FIELDS = Path(__file__).resolve().parents[1] / "fields"
SCENES = Path(__file__).resolve().parents[1] / "scenes"


# ------------------------------------------------------------------ kinds


@functools.lru_cache(maxsize=None)
def module_at(path: Path):
    """The Python file at `path`, loaded once: the benchmark's files found by
    name (fields, scenes, metric readers, kernel byte models)."""
    name = f"nerfbench_{path.parent.name}_{path.stem.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def field_of(config: dict):
    """The file of the configuration's field kind, `fields/<kind>.py`:
    `param_shapes(config)`, `features(...)`, `extra_loss(config, params)`,
    `CONTROL` and `TINY`."""
    return module_at(FIELDS / f"{config['field']['kind']}.py")


def scene_of(config: dict):
    """The file of the configuration's scene type, `scenes/<scene_type>.py`:
    the generated scene's rays, the occupancy states, the reference's march
    and the program's train keys."""
    return module_at(SCENES / f"{config['train']['scene_type']}.py")


# ------------------------------------------------------------------ hashing


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_u01(seed: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The stateless uniform of tinynerf's jitter and dropout: murmur3's
    finalizer of (two uint32 seed words, row, column), top 24 bits."""
    s0, s1 = seed[0].long() & _M32, seed[-1].long() & _M32
    h = (_mul32(rows.long() & _M32, 0x9E3779B9) + _mul32(cols.long() & _M32, 0x7FEB352D) + s0) & _M32
    h = _fmix32(h ^ s1)
    return (h >> 8).float() * (1.0 / (1 << 24))


# ------------------------------------------------------------------ numerics


def rounded(x: torch.Tensor, prec: str) -> torch.Tensor:
    """x rounded to `prec` (nearest, ties to even), its gradient passed
    straight through: the forward's rounding, the backward in float32."""
    if prec == "f32":
        return x
    if prec == "bf16":
        q = x.to(torch.bfloat16).float()
    elif prec == "fp8":
        q = torch.clamp(x, -FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float()
    else:
        raise ValueError(f"unknown precision {prec!r}")
    return x + (q - x).detach()


class _TruncExp(torch.autograd.Function):
    """exp(clamp(x, -15, 15)), whose gradient is g * exp(clamp(x, -15, 15))
    everywhere (tinynerf's guard against exploding densities)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp(x, -15.0, 15.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def mlp(params: Dict[str, torch.Tensor], prefix: str, n_layers: int, pieces: Sequence[torch.Tensor],
        prec: str) -> torch.Tensor:
    """ReLU between layers, none after the last; weights [in, out].  The
    input is the concatenation of `pieces`; each piece's product with its
    rows of the first layer is summed in float32 (rounded inputs), the
    bias added, the sum rounded; each later layer's product and its sum with
    the rounded bias are rounded."""
    w0 = params[f"{prefix}.w.0"]
    acc, at = 0.0, 0
    for piece in pieces:
        acc = acc + rounded(piece, prec) @ rounded(w0[at : at + piece.shape[-1]], prec)
        at += piece.shape[-1]
    if at != w0.shape[0]:
        raise ValueError(f"{prefix}: pieces cover {at} inputs of {w0.shape[0]}")
    x = rounded(acc + params[f"{prefix}.b.0"], prec)
    for i in range(1, n_layers):
        x = rounded(torch.relu(x) @ rounded(params[f"{prefix}.w.{i}"], prec), prec)
        x = rounded(x + rounded(params[f"{prefix}.b.{i}"], prec), prec)
    return x


def mlp_shapes(prefix: str, dims: Sequence[int]) -> Dict[str, tuple]:
    """Weight [in, out] and bias shapes of an MLP of widths `dims`, by the
    program's module names: every weight, then every bias."""
    shapes = {f"{prefix}.w.{i}": (a, b) for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}
    shapes.update({f"{prefix}.b.{i}": (b,) for i, b in enumerate(dims[1:])})
    return shapes


def posenc(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """Per coordinate [sin(2^k pi x) for k < n, cos(2^k pi x) for k < n]."""
    freqs = torch.tensor((2.0 ** np.arange(n_freqs)) * np.pi, dtype=x.dtype, device=x.device)
    xf = x[..., None] * freqs
    return torch.cat([torch.sin(xf), torch.cos(xf)], dim=-1).reshape(*x.shape[:-1], x.shape[-1] * 2 * n_freqs)


# ------------------------------------------------------------------ lookups


def _index(c: torch.Tensor, res: int):
    """Align-corners index of c in [-1, 1], its cell origin in [0, res-2]
    and the fraction past it (the last cell takes coordinate +1 with t=1)."""
    x = torch.clamp((c + 1.0) * 0.5 * (res - 1), 0.0, float(res - 1))
    x0 = torch.clamp(torch.floor(x), 0, res - 2)
    return x0.long(), x - x0


def bilinear(table: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """table [r0, r1, F] at c [n, 2] -> [n, F]."""
    r0, r1, f = table.shape
    (i, tx), (j, ty) = _index(c[:, 0], r0), _index(c[:, 1], r1)
    flat = table.reshape(-1, f)
    tx, ty = tx[:, None], ty[:, None]
    return (flat[i * r1 + j] * ((1 - tx) * (1 - ty)) + flat[i * r1 + j + 1] * ((1 - tx) * ty)
            + flat[(i + 1) * r1 + j] * (tx * (1 - ty)) + flat[(i + 1) * r1 + j + 1] * (tx * ty))


def trilinear(table: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """table [r0, r1, r2, F] at c [n, 3] -> [n, F]."""
    r0, r1, r2, f = table.shape
    (i, tx), (j, ty), (k, tz) = _index(c[:, 0], r0), _index(c[:, 1], r1), _index(c[:, 2], r2)
    flat = table.reshape(-1, f)
    out = 0.0
    for dx, wx in ((0, 1 - tx), (1, tx)):
        for dy, wy in ((0, 1 - ty), (1, ty)):
            for dz, wz in ((0, 1 - tz), (1, tz)):
                out = out + flat[((i + dx) * r1 + j + dy) * r2 + k + dz] * (wx * wy * wz)[:, None]
    return out


# ------------------------------------------------------------------ decoders


def decode(config: dict, params: Dict[str, torch.Tensor], feats: list, dirs: torch.Tensor, prec: str):
    """(sigma [n], rgb [n, 3]) from the feature pieces and unit view
    directions: sigma = exp(opacity MLP - 1), rgb = sigmoid(color MLP of
    [posenc(d), d, features])."""
    n_sig = len(config["sigma_decoder"]) - 1
    sigma = _TruncExp.apply(mlp(params, "sigma_decoder.mlp", n_sig, feats, prec)[:, 0] - 1.0)
    rgb_cfg = config["rgb_decoder"]
    pieces = [posenc(dirs, rgb_cfg["n_freqs"]), dirs, *feats]
    rgb = torch.sigmoid(mlp(params, "rgb_decoder.mlp", len(rgb_cfg["dims"]) - 1, pieces, prec))
    return sigma, rgb


# ------------------------------------------------------------------ render


def composite(sigma_rs: torch.Tensor, rgb_rs: torch.Tensor, keep: torch.Tensor, step: float,
              threshold: float, bg: float = 1.0) -> torch.Tensor:
    """Pixels [R, 3] from per-sample densities [R, S] and colors [R, S, 3]
    (zero where not kept): w_k = T_k (1 - exp(-sigma_k step)), T_k the
    transmittance before sample k, w_k = 0 once T_k <= threshold; over a
    white background."""
    s = sigma_rs * step * keep
    t_before = torch.exp(-(torch.cumsum(s, dim=-1) - s))
    w = torch.where(keep & (t_before > threshold), t_before * (1.0 - torch.exp(-s)), 0.0)
    return torch.sum(w[..., None] * rgb_rs, dim=-2) + bg * (1.0 - torch.sum(w, dim=-1))[..., None]


def render_rays(config: dict, params, rays_o, rays_d, grid, grid_mean, prec: str,
                jitter_seed=None, dropout_seed=None, ray_sel: Optional[torch.Tensor] = None):
    """Pixels of the rays (those of `ray_sel` only, when given) and the
    march's keep mask [R, S]: the scene's march, the field evaluated only
    at kept samples, a sample's dropout row (for a field that applies
    dropout) being its rank among all rays' kept samples."""
    train = config["train"]
    x, step, keep = scene_of(config).march(rays_o, rays_d, train, grid, grid_mean, jitter_seed)
    sel = keep if ray_sel is None else keep & ray_sel[:, None]
    rows = (torch.cumsum(keep.reshape(-1).long(), 0) - 1).reshape(keep.shape)[sel] if dropout_seed is not None else None
    feats = field_of(config).features(config, params, x[sel], prec, dropout_seed, rows)
    dirs = rays_d[:, None, :].expand(x.shape)[sel]
    sigma, rgb = decode(config, params, feats, dirs, prec)
    sigma_rs = torch.zeros(keep.shape, device=x.device).masked_scatter(sel, sigma)
    rgb_rs = torch.zeros(*keep.shape, 3, device=x.device).masked_scatter(sel[..., None].expand(*sel.shape, 3), rgb)
    return composite(sigma_rs, rgb_rs, sel, step, train["early_termination"]), keep


def step_batch(pool, seed: int, n_cand: int, device):
    """The batch and seed words of one step, as the training step draws them
    from its generator: ray indices uniform with replacement, then four
    words (jitter, dropout)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(0, pool[0].shape[0], (n_cand,), generator=gen, device=device)
    words = torch.randint(0, 2**32, (4,), generator=gen, device=device)
    return pool[0][idx], pool[1][idx], pool[2][idx], words[:2], words[2:]


def train_steps(config: dict, params0: Dict[str, torch.Tensor], pool, grid, grid_mean,
                steps: Sequence[tuple], prec: str = "f32", half_batch: bool = False) -> dict:
    """Training steps from params0 on the steps' (generator seed, candidate
    rays): each step marches its rays, trains on those whose samples all fit
    the cap (batch_size x n_samples, in ray order; rays with no sample
    count), takes MSE plus the field's extra loss terms, its gradient, L2
    decay on all but the tables and Adam.  `half_batch` is a planted
    fault: the mean over the first half of those rays only.  Returns per
    step the loss, kept samples and rays trained on; the first gradient's
    norm per leaf (decay included, as Adam receives it) and each leaf's
    change after the last step."""
    train, opt = config["train"], config["optimizer"]
    cap = train["batch_size"] * train["n_samples"]
    dev = grid.device
    field, scene = field_of(config), scene_of(config)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
        names = list(params)
        is_table = {k: any(k.startswith(t + ".") or k == t for t in opt["tables"]) for k in names}
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        nu = {k: torch.zeros_like(v) for k, v in params.items()}
        out = {"loss": [], "samples": [], "rays_used": []}
        for count, (seed, n_cand) in enumerate(steps, start=1):
            rays_o, rays_d, rgbs, jitter, dropout = step_batch(pool, seed, n_cand, dev)
            with torch.no_grad():
                _, _, keep = scene.march(rays_o, rays_d, train, grid, grid_mean, jitter)
                counts = keep.sum(dim=-1)
                fits = (torch.cumsum(counts, 0) <= cap) | (counts == 0)
            valid = fits & (torch.cumsum(fits.long(), 0) <= (int(fits.sum()) + 1) // 2) if half_batch else fits
            rgb, _ = render_rays(config, params, rays_o, rays_d, grid, grid_mean, prec, jitter, dropout, valid)
            mse = torch.mean((rgb - rgbs) ** 2, dim=-1)
            loss = torch.sum(mse * valid) / torch.clamp(valid.sum(), min=1)
            extra = field.extra_loss(config, params)
            if extra is not None:
                loss = loss + extra
            grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
            out["loss"].append(float(loss.detach()))
            out["samples"].append(int(torch.clamp(counts.sum(), max=cap)))
            out["rays_used"].append(int(fits.sum()))
            with torch.no_grad():
                c1 = 1.0 - opt["b1"] ** count
                c2 = 1.0 - opt["b2"] ** count
                for k, g in zip(names, grads):
                    p = params[k]
                    g = torch.zeros_like(p) if g is None else g
                    if not is_table[k]:
                        g = g + opt["weight_decay"] * p
                    if count == 1:
                        out.setdefault("grad_norm", {})[k] = float(torch.linalg.vector_norm(g))
                    mu[k].mul_(opt["b1"]).add_(g, alpha=1.0 - opt["b1"])
                    nu[k].mul_(opt["b2"]).addcmul_(g, g, value=1.0 - opt["b2"])
                    lr = opt["lr_tables"] if is_table[k] else opt["lr"]
                    p.add_(-lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + opt["eps"]))
        with torch.no_grad():
            out["update_norm"] = {k: float(torch.linalg.vector_norm(params[k] - params0[k])) for k in names}
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


@torch.no_grad()
def render_view(config: dict, params, rays_o: torch.Tensor, rays_d: torch.Tensor, grid, grid_mean,
                prec: str = "f32", block: int = 16384) -> torch.Tensor:
    """Pixels [n, 3] of rays [n, 3], marched densely in blocks of rays."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return torch.cat([render_rays(config, params, rays_o[a : a + block], rays_d[a : a + block],
                                      grid, grid_mean, prec)[0] for a in range(0, rays_o.shape[0], block)])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
