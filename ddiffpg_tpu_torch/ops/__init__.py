"""Tensor ops of acting and of the update pass: DDPM, mode embeddings,
noise, the optax chains, the C51 projection, running stats, posenc."""
