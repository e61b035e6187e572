from .step import (
    REMAT_POLICIES,
    build_loss_fn,
    build_param_specs,
    build_serve_step,
    build_train_step,
    make_train_state,
)

__all__ = [
    "REMAT_POLICIES",
    "build_loss_fn",
    "build_param_specs",
    "build_serve_step",
    "build_train_step",
    "make_train_state",
]
