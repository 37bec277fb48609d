"""Training: optimizer groups (optim), the CALM train step (steps) and the
step loop (loop), counterparts of audio_calm_tpu/train/."""
