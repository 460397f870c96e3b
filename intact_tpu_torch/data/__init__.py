"""Input pipeline: trajectory data -> training batches (the synthetic backend;
the RLDS/tf.data backend is not ported yet).

Batch schema (as intact_tpu/data):
  observation/image_primary  uint8 [B, T, H, W, C]
  observation/proprio        float32 [B, T, D]
  observation/timestep_pad_mask  bool [B, T]
  task/language_instruction  bytes [B]
  action                     float32 [B, T, horizon, dim]
  action_pad_mask            bool [B, T, horizon, dim]
"""

from intact_tpu_torch.data.dataset import InterleavedDataset

__all__ = ["InterleavedDataset"]
