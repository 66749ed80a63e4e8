"""Utilities (counterpart of :mod:`pydrobert_tpu.utils`)."""
