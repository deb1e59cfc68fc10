"""Device compute plane: HBM arenas, sort ops, the wave-pull mover and
attention (flash, Ulysses, ring). Importing it builds no kernel."""

from sparkrdma_tpu_torch.ops.hbm_arena import DeviceBuffer, DeviceBufferManager
from sparkrdma_tpu_torch.ops.pallas_attention import flash_attention
from sparkrdma_tpu_torch.ops.ring_attention import RingAttention
from sparkrdma_tpu_torch.ops.ulysses_attention import UlyssesAttention

__all__ = [
    "DeviceBuffer", "DeviceBufferManager", "RingAttention", "UlyssesAttention",
    "flash_attention",
]
