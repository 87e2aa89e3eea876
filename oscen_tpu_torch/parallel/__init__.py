"""oscen_tpu_torch.parallel: voice sharding over ``torch.distributed``."""
