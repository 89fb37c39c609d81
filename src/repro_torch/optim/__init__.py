"""Dense-parameter optimizers (the backbone's weights)."""

from repro_torch.optim.optimizers import (  # noqa: F401
    OPTIMIZERS,
    Optimizer,
    adafactor,
    adamw,
    adamw8bit,
    apply_updates,
    sgdm,
)
