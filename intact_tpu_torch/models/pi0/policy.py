"""Pi0Policy: the host-side policy interface around a model module.

The surface the serving stack consumes: language tokenization, state/image
padding to model dims, an action queue that re-infers every n_action_steps,
checkpoint load, and int8 (W8A8) serving. Device work is the model module's
`sample_actions` (pi0 by default; pi0fast takes the same signature);
everything else is numpy.

Over several ranks (`mesh` with a process group, one process per card) the
policy holds this rank's shard of the parameters (parallel/sharding.py's
rules at fsdp > 1, gathered layer by layer; at tensor > 1, Pi0, MVLA and
Pi0FAST, its tensor slice of the split leaves, whose towers then run their
local heads, by the model module's `tensor_heads`). The serving wrapper
(serve/policy_wrapper.py) owns the ranks' serving group: it pads the batch,
draws the padded batch's noise with `_draw_noise` on rank 0, and every rank
runs `_sample_rows` on its rows.
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
        mesh=None,
    ):
        """device: CUDA unless given (raises without a CUDA device).
        params: a param tree on that device (e.g. from convert.py); random
        weights from `seed` when omitted. use_bf16: bf16 params and compute
        (SERVING_POLICY), else fp32. tokenizer_path: HF tokenizer asset
        ("hash" for the hermetic fallback); ignored when a tokenizer object
        is passed. quantize: int8 W8A8 serving of the transformer-block
        matmuls and the projector (`cm.quantize_params`, leaf by leaf).
        model_module: a module with pi0's init / sample_actions signatures
        (pi0 by default; pi0fast). mesh: the ranks' mesh (parallel.make_mesh);
        at fsdp > 1 the policy holds this rank's shard of the parameters."""
        self.cfg = cfg
        self.model = model_module or pi0
        self.device = cm.resolve_device(device)
        self.policy = cm.SERVING_POLICY if use_bf16 else cm.FP32_POLICY
        self._quantize = quantize
        self.tokenizer = tokenizer or make_tokenizer(
            tokenizer_path, cfg.tokenizer_max_length, vocab_size=cfg.vlm.vocab_size
        )
        self.mesh = mesh
        if mesh is not None:
            from intact_tpu_torch.parallel.mesh import MeshConfig, refuse_tensor

            refuse_tensor(MeshConfig(mesh.data, mesh.fsdp, mesh.tensor), self.model.__name__.rsplit(".", 2)[-2],
                          serving=True)
        own = params is None
        if own:
            params = self.model.init(cfg, seed, self.device, self.policy.param_dtype)
        if quantize:  # a freshly made tree is ours to empty as it quantizes
            params = cm.quantize_params(params, consume=own)
        self.params = self._shard(params, consume=own or quantize)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._queue: deque = deque()

    def _sharded(self) -> bool:
        return self.mesh is not None and (self.mesh.fsdp > 1 or self.mesh.tensor > 1)

    def _heads(self) -> dict | None:
        return self.model.tensor_heads(self.cfg) if self.mesh is not None and self.mesh.tensor > 1 else None

    def _shard(self, params, consume: bool = False, put=None):
        """This rank's share of a whole tree (the tree itself at fsdp 1 and tensor 1)."""
        if not self._sharded():
            return params if put is None else cm.tree_map(put, params)
        from intact_tpu_torch.parallel.sharding import shard_tree

        return shard_tree(params, self.mesh, put=put, consume=consume, heads=self._heads())

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
            place = None
            if self._sharded():
                from intact_tpu_torch.parallel.sharding import shard_leaf

                place = lambda path, x: shard_leaf(path, x, self.mesh, heads=self._heads())  # noqa: E731
            params = cm.quantize_host_tree(restored, self.policy, self.device, place=place)
        else:  # each rank moves only its share of a leaf to its card
            params = self._shard(restored, put=lambda x: x.to(device=self.device, dtype=self.policy.param_dtype))
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

    @staticmethod
    def _normalized(images: torch.Tensor) -> torch.Tensor:
        if images.dtype == torch.uint8:
            # serving ships uint8 frames (4x fewer bytes to the device)
            images = images.to(torch.float32) * (2.0 / 255.0) - 1.0
        return images

    def device_inputs(self, batch: dict) -> tuple[torch.Tensor, ...]:
        """prepare_inputs on the device, images normalized to [-1, 1]."""
        images, img_masks, lang_tokens, lang_masks, state = (
            self._put(x) for x in self.prepare_inputs(batch)
        )
        return self._normalized(images), img_masks, lang_tokens, lang_masks, state

    def _sample_rows(self, images, img_masks, lang_tokens, lang_masks, state, noise=None) -> torch.Tensor:
        """sample_actions on device arrays (this rank's rows over a group);
        the policy's generator draws the noise unless it is given."""
        return self.model.sample_actions(
            self.params, self._generator, self._normalized(images), img_masks, lang_tokens, lang_masks, state,
            self.cfg, self.policy, noise=noise,
        )

    def sample_action_chunk(self, batch: dict) -> np.ndarray:
        """One inference -> [B, chunk_size, max_action_dim] float32."""
        return self._sample_rows(*(self._put(x) for x in self.prepare_inputs(batch))).cpu().numpy()

    def _draw_noise(self, rows: int) -> torch.Tensor:
        """The sampler's initial noise for `rows` rows, drawn as sample_actions draws it."""
        return pi0.sample_noise(self._generator, (rows, self.cfg.chunk_size, self.cfg.max_action_dim), self.device)

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
