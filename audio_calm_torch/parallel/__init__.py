"""Data parallelism, ZeRO and tensor-parallel placement for inference and
training (counterpart of audio_calm_tpu/parallel/)."""
