"""Sanity checks of a trained model and its data (counterpart of
audio_calm_tpu/diagnostics/)."""
