"""Plain PyTorch reference of what the cells compute: the AABB march with its
hash jitter, the occupancy cull, the fixed-capacity choice of the rays a
step trains on, the K-Planes and CoBaFa fields, the shared decoders, the
transmittance weights with early termination, compositing, the loss with
K-Planes' total variation, its gradient by autograd and Adam.

Written from the methods' published equations and the tinynerf
conventions (align-corners grids, ray-major sample order), with TF32 off,
in a precision `prec`: "f32" is the plain model; "bf16" the precision the
configurations state (table values rounded to bfloat16 before the lerp,
every matrix product of bfloat16 inputs summed in float32, and every
layer's output and each feature vector rounded to bfloat16); "fp8" the
same rounding points in float8_e4m3fn, the control one precision below.
It imports neither JAX nor the program, and takes from the program
nothing but the outputs it judges.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

_M32 = 0xFFFFFFFF
FP8_MAX = 448.0  # the largest finite float8_e4m3fn


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


# ------------------------------------------------------------------ fields


def field_features(config: dict, params: Dict[str, torch.Tensor], x: torch.Tensor, prec: str,
                   dropout_seed: Optional[torch.Tensor] = None, rows: Optional[torch.Tensor] = None) -> list:
    """The feature vector at contracted positions x [n, 3], as its pieces
    (their concatenation is the vector).  K-Planes: per scale the product of
    the three planes' lookups, rounded.  CoBaFa: per level the basis grid at
    sawtooth(f x) times the level's coefficient, dropout (keyed by the
    sample's row and feature column), into the field MLP."""
    field = config["field"]
    if field["kind"] == "kplanes":
        scales = []
        for s in range(len(field["resolutions"])):
            acc = None
            for p, (a, b) in enumerate(field["pairs"]):
                v = bilinear(rounded(params[f"field.planes.{s}.{p}"], prec), x[:, [a, b]])
                acc = v if acc is None else acc * v
            scales.append(rounded(acc, prec))
        return scales
    coefs = trilinear(rounded(params["field.coef"], prec), x)
    feats, col = [], 0
    for i, f in enumerate(field["freqs"]):
        saw = 2.0 * torch.remainder(f * x, 1.0) - 1.0
        y = trilinear(rounded(params[f"field.basis.{i}"], prec), saw) * coefs[:, i : i + 1]
        if dropout_seed is not None:
            p = field["dropout_p"]
            cols = torch.arange(col, col + y.shape[1], device=x.device)
            keep = hash_u01(dropout_seed, rows[:, None], cols[None, :]) >= p
            y = torch.where(keep, y / (1.0 - p), 0.0)
        feats.append(y)
        col += y.shape[1]
    return [mlp(params, "field.mlp", len(field["mlp"]) - 1, feats, prec)]


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


def tv_loss(config: dict, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """K-Planes' total variation, the mean over planes of the mean squared
    neighbour differences along both plane axes."""
    field = config["field"]
    total, count = 0.0, 0
    for s in range(len(field["resolutions"])):
        for p in range(len(field["pairs"])):
            plane = params[f"field.planes.{s}.{p}"]
            r0, r1, f = plane.shape
            v = plane.reshape(r0, r1 * f)
            total = total + torch.mean((v[1:] - v[:-1]) ** 2) + torch.mean((v[:, f:] - v[:, :-f]) ** 2)
            count += 1
    return total / count


# ------------------------------------------------------------------ march


def step_size(aabb, n_samples: int) -> float:
    lo, hi = np.array(aabb[0], np.float32), np.array(aabb[1], np.float32)
    return float(np.linalg.norm(hi - lo) / n_samples)


def march(rays_o: torch.Tensor, rays_d: torch.Tensor, train: dict, grid: torch.Tensor, grid_mean: torch.Tensor,
          jitter_seed: Optional[torch.Tensor] = None):
    """The AABB march: entry by the slab test (clamped to [near, 1e5] and
    nudged 1e-4 steps in), n_samples uniform steps of |diagonal| / n, each
    moved by u * step with the jitter hash; positions contracted to
    [-1, 1]^3 and kept where inside the box and at an occupied voxel
    (nearest, against min(mean, threshold)).  -> (x [R, S, 3], step, keep
    [R, S] bool)."""
    aabb, n = train["aabb"], train["n_samples"]
    step = step_size(aabb, n)
    box = torch.tensor(aabb, dtype=torch.float32, device=rays_o.device)
    d_safe = torch.where(rays_d == 0.0, rays_d + 1e-9, rays_d)
    planes = (box[:, None, :] - rays_o[None]) / d_safe[None]
    t_min = torch.clamp(torch.amax(torch.amin(planes, dim=0), dim=-1), train["near"], 1e5)
    t_min = t_min + np.float32(1e-4 * step).item()
    t = t_min[:, None] + (torch.arange(n, dtype=torch.float32, device=rays_o.device) * np.float32(step).item())[None]
    if jitter_seed is not None:
        u = hash_u01(jitter_seed, torch.arange(t.shape[0], device=t.device)[:, None],
                     torch.arange(n, device=t.device)[None, :])
        t = t + u * torch.full_like(t, np.float32(step).item())
    pos = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    inside = torch.all((pos >= box[0]) & (pos <= box[1]), dim=-1)
    x = (pos - box[0]) / (box[1] - box[0]) * 2.0 - 1.0
    r0, r1, r2 = grid.shape
    thr = torch.clamp(grid_mean, max=train["occupancy_threshold"])
    idx = [torch.clamp(torch.round((x[..., a] + 1.0) * 0.5 * (r - 1)), 0, r - 1).long()
           for a, r in enumerate((r0, r1, r2))]
    occupied = grid.reshape(-1)[(idx[0] * r1 + idx[1]) * r2 + idx[2]] > thr
    return x, np.float32(step).item(), inside & occupied


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
    march's keep mask [R, S]: the field is evaluated only at kept samples,
    a sample's dropout row being its rank among all rays' kept samples."""
    train = config["train"]
    x, step, keep = march(rays_o, rays_d, train, grid, grid_mean, jitter_seed)
    sel = keep if ray_sel is None else keep & ray_sel[:, None]
    rows = (torch.cumsum(keep.reshape(-1).long(), 0) - 1).reshape(keep.shape)[sel] if dropout_seed is not None else None
    feats = field_features(config, params, x[sel], prec, dropout_seed, rows)
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
    count), takes MSE + TV, its gradient, L2 decay on all but the tables and
    Adam.  `half_batch` is a planted fault: the mean over the first half of
    those rays only.  Returns per step the loss, kept samples and rays
    trained on; the first gradient's norm per leaf (decay included, as Adam
    receives it) and each leaf's change after the last step."""
    train, opt = config["train"], config["optimizer"]
    cap = train["batch_size"] * train["n_samples"]
    dev = grid.device
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
                _, _, keep = march(rays_o, rays_d, train, grid, grid_mean, jitter)
                counts = keep.sum(dim=-1)
                fits = (torch.cumsum(counts, 0) <= cap) | (counts == 0)
            valid = fits & (torch.cumsum(fits.long(), 0) <= (int(fits.sum()) + 1) // 2) if half_batch else fits
            rgb, _ = render_rays(config, params, rays_o, rays_d, grid, grid_mean, prec, jitter,
                                 dropout if config["field"]["kind"] == "cobafa" else None, valid)
            mse = torch.mean((rgb - rgbs) ** 2, dim=-1)
            loss = torch.sum(mse * valid) / torch.clamp(valid.sum(), min=1)
            if config["field"]["kind"] == "kplanes" and train["tv_reg_alpha"]:
                loss = loss + train["tv_reg_alpha"] * tv_loss(config, params)
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
