"""Simulator-facing host code (env adapters, task suites and the simulator-client
evaluators), ported from intact_tpu/envs."""
