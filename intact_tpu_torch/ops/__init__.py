"""Attention, masks, RoPE, and the hand-written CUDA kernels they launch."""
