"""Device compute plane: HBM arenas, sort ops, the wave-pull and
neighbor-pull movers, the exchange program over a mesh, and attention
(flash forward and backward, Ulysses, ring). Importing it builds no
kernel."""

from sparkrdma_tpu_torch.ops.exchange import ExchangeProgram
from sparkrdma_tpu_torch.ops.hbm_arena import DeviceBuffer, DeviceBufferManager
from sparkrdma_tpu_torch.ops.pallas_attention import (
    flash_attention,
    flash_attention_bwd,
)
from sparkrdma_tpu_torch.ops.remote_copy import neighbor_pull, ppermute
from sparkrdma_tpu_torch.ops.ring_attention import RingAttention
from sparkrdma_tpu_torch.ops.ulysses_attention import UlyssesAttention
from sparkrdma_tpu_torch.parallel.mesh import make_mesh

__all__ = [
    "DeviceBuffer", "DeviceBufferManager", "ExchangeProgram", "RingAttention",
    "UlyssesAttention", "flash_attention", "flash_attention_bwd", "make_mesh",
    "neighbor_pull", "ppermute",
]
