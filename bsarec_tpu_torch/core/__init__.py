"""The device mesh (counterpart of `bsarec_tpu/core/`)."""
