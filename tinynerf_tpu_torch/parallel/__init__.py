"""Data parallelism over `torch.distributed` (one process per device)."""

from .mesh import DataGroup, make_group, shard_rays, single, wrap_default_group

__all__ = ["DataGroup", "make_group", "shard_rays", "single", "wrap_default_group"]
