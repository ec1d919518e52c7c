from .checkpoint import (restore_checkpoint, save_checkpoint, scan_checkpoint,
                         wait_for_checkpoints)
from .loop import train
from .loop_joint import train_joint
from .trainer import GANTrainer, apply_update, fetch_scalars, learning_rate, make_optimizer
