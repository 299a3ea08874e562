"""Post-processing: denoiser, composite and tone mapping."""
