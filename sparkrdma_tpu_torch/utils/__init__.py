from sparkrdma_tpu_torch.utils.config import TpuShuffleConf
from sparkrdma_tpu_torch.utils.units import format_bytes, parse_bytes

__all__ = ["TpuShuffleConf", "format_bytes", "parse_bytes"]
