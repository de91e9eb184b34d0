from longbow_tpu_torch.metrics.registry import MetricsRegistry, get_registry  # noqa: F401
