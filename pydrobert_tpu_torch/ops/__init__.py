"""Operations (counterpart of :mod:`pydrobert_tpu.ops`)."""
