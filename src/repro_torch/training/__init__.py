"""Training substrate (``repro/training`` in PyTorch): AdamW written out
as the reference writes it, chunked cross-entropy, the train step with
remat and micro-batching."""
from .optimizer import (AdamWConfig, apply_updates, global_norm,  # noqa: F401
                        init_state, schedule)
from .train_step import (  # noqa: F401
    chunked_softmax_xent, init_train_state, make_loss_fn, make_train_step)
