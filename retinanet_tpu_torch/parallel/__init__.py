"""Data-parallel and multi-process runs on ``torch.distributed``."""
