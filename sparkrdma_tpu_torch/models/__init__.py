"""Workload models of the port."""

from sparkrdma_tpu_torch.models.terasort import MapShardSorter, TeraSorter

__all__ = ["MapShardSorter", "TeraSorter"]
