"""tpu_dist_torch.benchmarks — the port's counterparts of ``benchmarks/``."""
