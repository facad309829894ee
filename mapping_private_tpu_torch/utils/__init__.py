"""Stage timers, counters and profiler traces."""
from mapping_private_tpu_torch.utils.metrics import Metrics, StageStats, metrics

__all__ = ["Metrics", "StageStats", "metrics"]
