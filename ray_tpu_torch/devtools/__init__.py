"""Developer tools of the port that run beside it, not inside it: the lint
(`python -m ray_tpu_torch.devtools.lint`). Standard library only."""
