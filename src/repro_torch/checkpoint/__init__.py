from repro_torch.checkpoint.store import (
    AsyncCheckpointer,
    latest_step,
    restore,
    save,
    valid_steps,
)

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save",
           "valid_steps"]
