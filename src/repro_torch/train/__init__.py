"""Training path of the port: optimizer, checkpoints, the sequential engine
and the trainer (``Trainer``, ``TrainerConfig``)."""
