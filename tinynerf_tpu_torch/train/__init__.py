from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .config import TrainConfig
from .loop import (
    InferStats,
    build_renderer,
    evaluate,
    infer,
    make_render_chunk,
    make_render_chunk_packed,
    render_only,
)
from .metrics import EvalMetrics, eval_metrics, psnr, ssim

__all__ = [
    "TrainConfig",
    "InferStats",
    "build_renderer",
    "evaluate",
    "infer",
    "make_render_chunk",
    "make_render_chunk_packed",
    "render_only",
    "EvalMetrics",
    "eval_metrics",
    "psnr",
    "ssim",
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint",
]
