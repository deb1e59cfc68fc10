"""Workload models of the port."""

from sparkrdma_tpu_torch.models.terasort import MapShardSorter, TeraSorter
from sparkrdma_tpu_torch.models.transformer_step import (
    TransformerBlock,
    TransformerStep,
    init_params,
    make_training_mesh,
    reference_step,
)

__all__ = ["MapShardSorter", "TeraSorter", "TransformerBlock",
           "TransformerStep", "init_params", "make_training_mesh",
           "reference_step"]
