"""Training: the diffusion train step (loss, clip, AdamW, EMA), checkpoints
and the ``Trainer`` loop.  Import from the submodules."""
