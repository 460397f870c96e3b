"""Simulator-facing host code (env adapters), copied from intact_tpu/envs."""
