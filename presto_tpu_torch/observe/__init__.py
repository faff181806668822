"""Query and per-operator statistics (reference: presto_tpu/observe)."""

from presto_tpu_torch.observe.stats import NodeStats, QueryMonitor, QueryStats

__all__ = ["NodeStats", "QueryMonitor", "QueryStats"]
