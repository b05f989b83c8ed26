"""Tensor ops of acting, of the update pass and of the recluster: DDPM,
mode embeddings, noise, the optax chains, the C51 projection, running
stats, posenc, DTW (plain wavefront and the CUDA kernel's binding), the
baselines' n-step window and schedules."""
