"""Host utilities: seeding and class lookup, logging, the uint8 frame codec,
rotation conversions (copies of JAX-free parts of intact_tpu/utils)."""
