from .checkpoint import restore_checkpoint, save_checkpoint, scan_checkpoint
from .loop import train
from .trainer import GANTrainer, apply_update, fetch_scalars, learning_rate, make_optimizer
