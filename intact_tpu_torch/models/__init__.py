"""Model towers and the Pi0 policy, as plain functions over dicts of tensors."""
