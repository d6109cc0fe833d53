"""Training of the port: losses, step functions, the loop (the port of the
JAX package's `repro.train`)."""
from .loop import train_loop
from .steps import (TrainState, diffusion_loss, init_train_state, lm_loss,
                    make_diffusion_train_step, make_lm_train_step)

__all__ = ["lm_loss", "diffusion_loss", "make_lm_train_step",
           "make_diffusion_train_step", "TrainState", "init_train_state",
           "train_loop"]
