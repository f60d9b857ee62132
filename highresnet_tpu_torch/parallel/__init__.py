"""Multi-process data parallelism (``torch.distributed``): one process per card,
each training on its shard of the global batch."""
