from repro_torch.checkpoint.manager import (CheckpointManager, latest_step,
                                            load_arrays, restore_checkpoint,
                                            save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "load_arrays",
           "restore_checkpoint", "save_checkpoint"]
