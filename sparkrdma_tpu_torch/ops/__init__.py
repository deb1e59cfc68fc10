"""Device compute plane: HBM arenas, sort ops and the wave-pull mover."""

from sparkrdma_tpu_torch.ops.hbm_arena import DeviceBuffer, DeviceBufferManager

__all__ = ["DeviceBuffer", "DeviceBufferManager"]
