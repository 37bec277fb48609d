"""Data parallelism, ZeRO and tensor-parallel inference placement
(counterpart of audio_calm_tpu/parallel/)."""
