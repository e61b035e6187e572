from .checkpoint import CheckpointInfo, CheckpointManager

__all__ = ["CheckpointInfo", "CheckpointManager"]
