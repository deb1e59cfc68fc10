"""Workload models of the port."""

from sparkrdma_tpu_torch.models.als import ALS, reference_als, rmse
from sparkrdma_tpu_torch.models.hashjoin import HashJoin
from sparkrdma_tpu_torch.models.pagerank import PageRank, reference_pagerank
from sparkrdma_tpu_torch.models.terasort import MapShardSorter, TeraSorter
from sparkrdma_tpu_torch.models.transformer_step import (
    TransformerBlock,
    TransformerStep,
    init_params,
    make_training_mesh,
    reference_step,
)

__all__ = ["ALS", "HashJoin", "MapShardSorter", "PageRank", "TeraSorter",
           "TransformerBlock", "TransformerStep", "init_params",
           "make_training_mesh", "reference_als", "reference_pagerank",
           "reference_step", "rmse"]
