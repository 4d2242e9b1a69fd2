"""The latent-diffusion training step and its parts: optimizer and train
state, EMA, scalar logging."""
