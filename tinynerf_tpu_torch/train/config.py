"""Run configuration.

Counterpart of `tinynerf_tpu/train/config.py`, field for field, so one set
of flags drives both packages; the JAX file documents each field.  The
serving slice reads the model, marching, occupancy and eval fields; the
training fields wait for the training slice.  Mesh and sharding fields
(`shard_tables`, `shard_bwd`) have no effect: the port runs on one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple


@dataclass
class TrainConfig:
    method: str = "kplanes"  # vanilla | kplanes | cobafa
    scene_type: str = "aabb"  # aabb | unbounded
    output: Path = Path("output")

    batch_size: int = 2048  # target rays/step (defines the sample budget)
    n_samples: int = 400  # marcher samples per ray

    eval_every: Optional[int] = None
    eval_n: Optional[int] = None

    seed: int = 0

    steps: Optional[int] = None  # default 2048 * bs_ratio
    occupancy_update_every: Optional[int] = None  # default 16 * bs_ratio
    occupancy_res: int = 128
    occupancy_threshold: float = 0.01
    occupancy_decay: Optional[float] = None
    occupancy_interp: str = "nearest"

    decay_tables: bool = False

    lr_init: Optional[float] = None
    lr_tables: Optional[float] = None
    adam_eps: float = 1e-15
    weight_decay: float = 1e-5
    tv_reg_alpha: float = 1e-4  # kplanes only
    l1_reg_alpha: float = 0.0  # kplanes only
    lr_milestones: Tuple[float, ...] = (0.5, 0.75, 5.0 / 6.0, 0.9)
    lr_gamma: float = 0.33

    aabb: Tuple[Tuple[float, float, float], Tuple[float, float, float]] = (
        (-1.5, -1.5, -1.5),
        (1.5, 1.5, 1.5),
    )
    near: float = 0.1

    compute_dtype: str = "bfloat16"  # bfloat16 | float32 (MLP matmul dtype; f32 masters)
    ray_buckets: Tuple[int, ...] = (1, 2, 3, 4, 6, 8, 12, 16, 20, 24, 32, 48, 64)
    max_bucket: Optional[int] = None
    bucket_overfill: float = 1.15
    early_termination: float = 1e-4
    field_scale: float = 1.0
    fwd_clamp: bool = True
    shard_tables: bool = False
    shard_bwd: bool = False
    march: str = "auto"  # auto | dense | skip
    skip_steps: Optional[int] = None
    remat_field: Optional[bool] = None
    checkpoint_every: int = 0
    profile_start: Optional[int] = None
    profile_count: int = 5
    eval_render: str = "packed"  # packed | dense
    eval_samples_per_ray: int = 64

    @property
    def effective_skip_steps(self) -> int:
        if self.skip_steps is not None:
            return self.skip_steps
        return 96 if self.scene_type == "unbounded" else 64

    @property
    def effective_lr(self) -> float:
        if self.lr_init is not None:
            return self.lr_init
        if self.method == "vanilla":
            return 1e-3
        if self.method == "cobafa":
            return 3e-3
        return 1e-2

    @property
    def effective_lr_tables(self) -> Optional[float]:
        if self.lr_tables is not None:
            return self.lr_tables
        return 1e-2 if self.method == "cobafa" else None

    @property
    def bs_ratio(self) -> float:
        return 4096.0 / self.batch_size

    @property
    def total_steps(self) -> int:
        return self.steps if self.steps is not None else int(2048 * self.bs_ratio)

    @property
    def occ_update_every(self) -> int:
        if self.occupancy_update_every is not None:
            return self.occupancy_update_every
        return max(1, int(16 * self.bs_ratio))

    @property
    def occ_decay(self) -> float:
        if self.occupancy_decay is not None:
            return self.occupancy_decay
        return self.occupancy_threshold ** (1.0 / 16.0)

    @property
    def sample_cap(self) -> int:
        """Fixed per-step sample budget = batch_size * n_samples."""
        return self.batch_size * self.n_samples
