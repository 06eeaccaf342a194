"""The benchmark's plain float32 reference of the dual encoder, its training
step and its serving inputs.  It imports nothing of the measured program."""
