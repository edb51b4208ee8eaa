from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,
                                         restore_checkpoint, save_checkpoint)
