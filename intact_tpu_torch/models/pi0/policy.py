"""Pi0Policy: the host-side policy interface around a model module.

The surface the serving stack consumes: language tokenization, state/image
padding to model dims, an action queue that re-infers every n_action_steps,
checkpoint load, and int8 (W8A8) serving. Device work is the model module's
`sample_actions` (pi0 by default; pi0fast takes the same signature);
everything else is numpy.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from intact_tpu_torch.models import common as cm
from intact_tpu_torch.models.pi0 import model as pi0
from intact_tpu_torch.models.tokenizer import make_tokenizer
from intact_tpu_torch.train import checkpoint as ckpt_lib


class Pi0Policy:
    def __init__(
        self,
        cfg,
        params=None,
        tokenizer=None,
        seed: int = 0,
        use_bf16: bool = True,
        tokenizer_path: str | None = None,
        device=None,
        quantize: bool = False,
        model_module=None,
    ):
        """device: CUDA unless given (raises without a CUDA device).
        params: a param tree on that device (e.g. from convert.py); random
        weights from `seed` when omitted. use_bf16: bf16 params and compute
        (SERVING_POLICY), else fp32. tokenizer_path: HF tokenizer asset
        ("hash" for the hermetic fallback); ignored when a tokenizer object
        is passed. quantize: int8 W8A8 serving of the transformer-block
        matmuls and the projector (`cm.quantize_params`, leaf by leaf).
        model_module: a module with pi0's init / sample_actions signatures
        (pi0 by default; pi0fast)."""
        self.cfg = cfg
        self.model = model_module or pi0
        self.device = cm.resolve_device(device)
        self.policy = cm.SERVING_POLICY if use_bf16 else cm.FP32_POLICY
        self._quantize = quantize
        self.tokenizer = tokenizer or make_tokenizer(
            tokenizer_path, cfg.tokenizer_max_length, vocab_size=cfg.vlm.vocab_size
        )
        if params is None:
            params = self.model.init(cfg, seed, self.device, self.policy.param_dtype)
            if quantize:  # the freshly made tree is ours to empty as it quantizes
                params = cm.quantize_params(params, consume=True)
        elif quantize:
            params = cm.quantize_params(params)
        self.params = params
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._queue: deque = deque()

    # ------------------------------------------------------------------
    # checkpoints (step_{n} contract, hot-swappable)
    # ------------------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, path: str, cfg, **kwargs) -> "Pi0Policy":
        policy = cls(cfg, **kwargs)
        policy.load(path)
        return policy

    def load(self, path: str) -> None:
        """Restore params from a step dir (or the newest committed step under
        a root). Checkpoints hold fp params: they stream to the device one
        leaf at a time in the param dtype, quantized on the way when the
        policy serves int8, and replace the old tree once complete."""
        restored = ckpt_lib.restore_params(path, self.model.init(self.cfg, device="meta"))
        if self._quantize:
            params = cm.quantize_host_tree(restored, self.policy, self.device)
        else:
            params = cm.tree_map(lambda x: x.to(device=self.device, dtype=self.policy.param_dtype), restored)
        self.params = params
        self.reset()

    def reset(self) -> None:
        self._queue.clear()

    def prepare_inputs(self, batch: dict):
        """Normalize a host obs batch into model arrays (numpy).

        batch keys: "image" [B, H, W, 3] (uint8, or float in [-1, 1]) or
        [B, K, H, W, 3]; "state" [B, <=max_state_dim]; "task" list[str].
        """
        image = np.asarray(batch["image"])
        if image.dtype != np.uint8:  # uint8 normalizes on the device
            image = image.astype(np.float32)
        if image.ndim == 4:
            image = image[:, None]  # add camera axis
        b = image.shape[0]
        img_masks = np.ones((b, image.shape[1]), bool)

        lang_tokens, lang_masks = self.tokenizer(
            list(batch["task"]), self.cfg.tokenizer_max_length
        )

        state_in = np.asarray(batch["state"], np.float32)
        state = np.zeros((b, self.cfg.max_state_dim), np.float32)
        state[:, : state_in.shape[-1]] = state_in
        return image, img_masks, lang_tokens, lang_masks, state

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(x)).to(self.device)  # np.array: a writable copy

    def device_inputs(self, batch: dict) -> tuple[torch.Tensor, ...]:
        """prepare_inputs on the device, images normalized to [-1, 1]."""
        images, img_masks, lang_tokens, lang_masks, state = (
            self._put(x) for x in self.prepare_inputs(batch)
        )
        if images.dtype == torch.uint8:
            # serving ships uint8 frames (4x fewer bytes to the device)
            images = images.to(torch.float32) * (2.0 / 255.0) - 1.0
        return images, img_masks, lang_tokens, lang_masks, state

    def sample_action_chunk(self, batch: dict) -> np.ndarray:
        """One inference -> [B, chunk_size, max_action_dim] float32."""
        actions = self.model.sample_actions(
            self.params, self._generator, *self.device_inputs(batch), self.cfg, self.policy
        )
        return actions.cpu().numpy()

    def select_action(self, batch: dict, action_dim: int | None = None) -> np.ndarray:
        """Queue semantics: re-infer when the queue of n_action_steps actions
        drains; returns [B, action_dim]."""
        if not self._queue:
            chunk = self.sample_action_chunk(batch)
            if action_dim is not None:
                chunk = chunk[:, :, :action_dim]
            for i in range(min(self.cfg.n_action_steps, chunk.shape[1])):
                self._queue.append(chunk[:, i])
        return self._queue.popleft()
