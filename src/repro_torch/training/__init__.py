from repro_torch.training.optim import AdamWState, adamw_init, adamw_update, cosine_lr
from repro_torch.training.train import TrainState, make_train_step, train_loop

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_lr",
           "TrainState", "make_train_step", "train_loop"]
