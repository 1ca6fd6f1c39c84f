"""Training: the data stream, AdamW, the microbatched train step, checkpoints,
elastic resume and int8 gradient compression (the JAX package's ``train/``)."""
