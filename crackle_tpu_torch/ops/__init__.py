"""Operations of crackle_tpu_torch over whole streams: device
analytics."""
