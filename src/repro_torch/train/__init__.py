"""Training and serving steps of the port (counterpart of
``repro.train``): the optimizers, the train step, prefill and decode;
checkpoints are ``train.checkpoint``, and the trainer loop that drives
them is ``launch.train.train``."""
from repro_torch.train.optimizer import adafactor, adamw, make_optimizer
from repro_torch.train.serve_step import make_decode_step, make_prefill
from repro_torch.train.train_step import make_train_step

__all__ = ["adafactor", "adamw", "make_optimizer", "make_train_step",
           "make_decode_step", "make_prefill"]
