from .adamw import AdamWConfig, apply_updates, global_norm, init_state, schedule

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_state", "schedule"]
