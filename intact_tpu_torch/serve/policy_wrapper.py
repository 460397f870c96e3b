"""Policy wrappers: glue between the wire protocol, env adapters and the model.

The Pi0, native SpatialVLA, native Magma and Octo parts of intact_tpu/serve/policy_wrapper.py:
`select_action(obs) -> np.ndarray [action_step, dim]`, `reset()`, `switch_model(path)` (hot
checkpoint swap for checkpoint sweeps), and ONE fused-batch contract,
`infer_batch(items)`, that both the per-request path (`select_action`) and
the continuous-batching server route through.

Per-connection episode state (the env adapter's episode state) lives in a
`PolicySession`, created per websocket connection by the batching server via
`new_session()`; the shared policy on the card stays stateless across
co-batched clients. The wrapper serves one card (CUDA unless the caller
passes device="cpu"); serving over several cards and the HF-scaffold
SpatialVLA and Magma wrappers are ROADMAP items.
"""

from __future__ import annotations

import numpy as np
import torch

from intact_tpu_torch.utils.monitor import setup_logger
from intact_tpu_torch.utils.pipeline import get_class_from_path, set_seed_everywhere


class PolicySession:
    """Per-connection episode state: a fresh env adapter. One client's
    `reset` resets only its own session; co-batched neighbours and the shared
    policy are untouched."""

    # sessions on the uint8 wire ask the adapter to skip its float normalize
    # (adapters that support output_uint8 emit the resized uint8 frame)
    wants_uint8 = False

    def __init__(self, wrapper: "BasePolicyWrapper", adapter):
        self.wrapper = wrapper
        self.adapter = adapter
        # episode state from a model that has since been hot-swapped must not
        # leak into the new model's episodes: infer_batch resets any session
        # whose generation lags the wrapper's
        self.model_generation = getattr(wrapper, "model_generation", 0)
        if self.wants_uint8 and hasattr(adapter, "output_uint8"):
            adapter.output_uint8 = True

    def preprocess(self, obs: dict) -> dict:
        return self.adapter.preprocess(obs)

    def reset(self) -> None:
        self.adapter.reset()


class BasePolicyWrapper:
    session_cls = PolicySession
    # class-level default so partially constructed wrappers (test stubs via
    # __new__) still satisfy the generation protocol; __init__ shadows it
    model_generation = 0

    def __init__(self, config):
        self.config = config
        self.logger = setup_logger(True, name="policy_wrapper")
        set_seed_everywhere(config.seed)
        self.env_adapter = get_class_from_path(config.eval_cfg.env_adapter_path)(config)
        self.action_step = config.eval_cfg.action_step
        self._default_session: PolicySession | None = None
        self.model_generation = 0  # bumped by every switch_model

    # ------------------------------------------------------------------
    # session / fuse surface (consumed by serve.batching)
    # ------------------------------------------------------------------

    @property
    def session(self) -> PolicySession:
        """The wrapper's own session (the per-request server path)."""
        if self._default_session is None:
            self._default_session = self.session_cls(self, self.env_adapter)
        return self._default_session

    def new_session(self) -> PolicySession:
        """Fresh per-connection state for the batching server."""
        adapter = get_class_from_path(self.config.eval_cfg.env_adapter_path)(self.config)
        return self.session_cls(self, adapter)

    def fuse_key(self, inputs: dict):
        """Requests whose inputs share this key may be fused into one device
        batch; a client sending odd shapes or dtypes forms its own group.

        Also the per-request validation gate: raising here rejects only the
        offending request. A request whose task list is shorter than its
        image rows would shift every co-batched neighbour's language
        conditioning after the row-offset flatten, so it is refused here."""
        task = inputs.get("task")
        img = inputs.get("image")
        if isinstance(task, (list, tuple)) and isinstance(img, np.ndarray):
            if len(task) != img.shape[0] or not task:
                raise ValueError(
                    f"request has {img.shape[0]} image row(s) but {len(task)} task string(s); per-row "
                    "task conditioning requires one task per row"
                )
        return tuple(
            (k, v.shape[1:], str(v.dtype))
            for k, v in sorted(inputs.items())
            if isinstance(v, np.ndarray)
        )

    def bucket_size(self, n: int) -> int:
        """Fused device batches pad to power-of-two buckets, capped at
        eval_cfg.max_batch_size, so the device sees a bounded set of batch
        shapes. Row counts beyond max_batch are served by splitting the
        device call (Pi0PolicyWrapper._infer_fused)."""
        b = 1
        while b < n:
            b *= 2
        return min(b, self.config.eval_cfg.max_batch_size)

    def bucket_sizes(self) -> list[int]:
        sizes, b = [], 1
        max_b = max(int(self.config.eval_cfg.max_batch_size), 1)
        while b < max_b:
            sizes.append(b)
            b *= 2
        sizes.append(max_b)
        return sizes

    def infer_batch(self, items: list[tuple[dict, PolicySession]]):
        """THE fuse contract: N (inputs, session) pairs -> N results in
        order, each an env-action array or an Exception (one client's failing
        postprocess must not kill co-batched neighbours).

        The batching server's fuse cap may exceed eval_cfg.max_batch_size;
        oversized fuses are split here so _infer_fused never sees more items
        than the bucket ceiling."""
        # sessions created before a hot model swap carry the old model's
        # episode state: they reset at their next inference
        for _, session in items:
            if session.model_generation != self.model_generation:
                session.reset()
                session.model_generation = self.model_generation

        max_b = max(int(self.config.eval_cfg.max_batch_size), 1)
        if len(items) <= max_b:
            return self._infer_fused(items)
        out = []
        for start in range(0, len(items), max_b):
            out.extend(self._infer_fused(items[start:start + max_b]))
        return out

    def _infer_fused(self, items: list[tuple[dict, PolicySession]]):
        """Family fused-inference hook (items already capped at
        eval_cfg.max_batch_size)."""
        raise NotImplementedError

    def _fuse_pad(self, items, keys) -> tuple[dict, list[str]]:
        """The fuse of single-row requests: each `keys` array concatenated
        over the items, its last row repeated up to the bucket, and the task
        list padded to match -> (arrays by key, tasks)."""
        n = len(items)
        pad = self.bucket_size(n) - n
        arrays = {}
        for key in keys:
            arr = np.concatenate([it[0][key] for it in items])
            arrays[key] = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)]) if pad else arr
        tasks = [it[0]["task"][0] for it in items]
        return arrays, tasks + [tasks[-1]] * pad

    def warmup_inputs(self) -> dict:
        """One post-preprocess request the server can replicate to run every
        fused-batch bucket before accepting traffic."""
        raise NotImplementedError

    def prewarm(self) -> None:
        """Run one dummy inference per bucket, so the first clients meet no
        first-call costs (kernel builds, allocator growth)."""
        session = self.new_session()
        inputs = self.warmup_inputs()
        for b in self.bucket_sizes():
            results = self.infer_batch([(inputs, session)] * b)
            for r in results:
                if isinstance(r, Exception):  # only the dummy postprocess failed
                    self.logger.warning("prewarm postprocess: %s", r)
                    break
            self.logger.info("prewarmed bucket %d", b)

    # ------------------------------------------------------------------
    # per-request surface
    # ------------------------------------------------------------------

    def reset(self) -> None:
        self.session.reset()

    def switch_model(self, new_model_path: str) -> None:
        raise NotImplementedError

    def select_action(self, obs: dict) -> np.ndarray:
        res = self.infer_batch([(self.session.preprocess(obs), self.session)])[0]
        if isinstance(res, Exception):
            raise res
        return res


class Pi0Session(PolicySession):
    """Ships frames as uint8: adapters that support it emit the resized uint8
    frame (output_uint8); a float [-1, 1] frame from any other adapter is
    re-encoded, which recovers the pixels of a frame resized uint8 -> uint8.
    The policy normalizes on the card, so the host->device copy carries 4x
    fewer bytes."""

    wants_uint8 = True

    def preprocess(self, obs: dict) -> dict:
        from intact_tpu_torch.utils.device import float_to_u8

        inputs = self.adapter.preprocess(obs)
        inputs["image"] = float_to_u8(np.asarray(inputs["image"]))
        return inputs


class Pi0PolicyWrapper(BasePolicyWrapper):
    """Serves Pi0, Pi0FAST and MVLA (mvla, mmmvla) checkpoints of the port
    (bf16, or int8 with eval_cfg.quantize_int8) on one card; the model
    module comes from the registry by model type."""

    session_cls = Pi0Session

    def __init__(self, config, device=None):
        """device: CUDA unless given (raises without a CUDA device)."""
        super().__init__(config)
        from intact_tpu_torch.models import registry
        from intact_tpu_torch.models.pi0.policy import Pi0Policy

        self.model_cfg = config.make_model_config()
        self.policy = Pi0Policy(
            self.model_cfg, seed=config.seed, use_bf16=config.use_bf16,
            tokenizer_path=config.resolve_tokenizer_path(), device=device,
            quantize=config.eval_cfg.quantize_int8, model_module=registry.module(config.model_type),
        )
        path = config.eval_cfg.pretrained_model_path
        if path:
            self.policy.load(path)
            self.logger.info("loaded checkpoint %s", path)

    def reset(self) -> None:
        super().reset()
        self.policy.reset()

    def switch_model(self, new_model_path: str) -> None:
        self.policy.load(new_model_path)
        self.env_adapter.reset()
        self.model_generation += 1

    def warmup_inputs(self) -> dict:
        h, w = self.config.env.image_size
        return {
            "image": np.zeros((1, h, w, 3), np.uint8),
            "state": np.zeros((1, self.model_cfg.max_state_dim), np.float32),
            "task": ["warmup"],
        }

    def _infer_fused(self, items):
        """Fuse N requests' {image, state, task} into bucketed
        sample_action_chunk calls, then scatter the per-item postprocess.
        Requests may carry several rows each (vectorized clients); row totals
        beyond max_batch_size run as several max_batch-sized device calls."""
        rows = [it[0]["image"].shape[0] for it in items]
        n = sum(rows)
        imgs = np.concatenate([it[0]["image"] for it in items])
        states = np.concatenate([it[0]["state"] for it in items])
        tasks = [t for it in items for t in it[0]["task"]]

        max_b = max(int(self.config.eval_cfg.max_batch_size), 1)
        parts = []
        for start in range(0, n, max_b):
            stop = min(start + max_b, n)
            m = stop - start
            pad = self.bucket_size(m) - m
            ci, cs = imgs[start:stop], states[start:stop]
            ct = tasks[start:stop]
            if pad:  # replicate the last row up to the bucket boundary
                ci = np.concatenate([ci, np.repeat(ci[-1:], pad, axis=0)])
                cs = np.concatenate([cs, np.repeat(cs[-1:], pad, axis=0)])
                ct = ct + [ct[-1]] * pad
            parts.append(self.policy.sample_action_chunk({"image": ci, "state": cs, "task": ct})[:m])
        chunks = parts[0] if len(parts) == 1 else np.concatenate(parts)  # [n, chunk, max_action_dim]

        out, offset = [], 0
        for (inputs, session), r in zip(items, rows):
            try:
                env_dim = len(session.adapter.dataset_statistics["action"]["mean"])
                sl = chunks[offset:offset + r, : self.action_step, :env_dim]
                if hasattr(session.adapter, "postprocess_batch"):
                    out.append(session.adapter.postprocess_batch(sl))
                else:
                    out.append(session.adapter.postprocess(sl[0]))
            except Exception as e:  # noqa: BLE001 — isolated per request
                out.append(e)
            offset += r
        return out


class SpatialVLASession(PolicySession):
    """SpatialVLA's per-connection state: its exponentially weighted chunk
    ensembler (reference simpler.py:492-519). preprocess does the host-side
    resize and depth preparation, so the fused device call sees model-shaped
    arrays; frames ship as uint8 and normalize on the card."""

    wants_uint8 = True

    def __init__(self, wrapper, adapter):
        super().__init__(wrapper, adapter)
        from intact_tpu_torch.envs.adapters.simpler import ActionEnsembler

        self.ensembler = ActionEnsembler(pred_horizon=wrapper.model_cfg.n_action_steps)

    def preprocess(self, obs: dict) -> dict:
        import cv2

        from intact_tpu_torch.utils.device import float_to_u8

        cfg = self.wrapper.model_cfg
        inputs = self.adapter.preprocess(obs)
        if inputs["image"].shape[0] != 1:
            # the ensembler is one episode's state: a vectorized request has no meaning through it
            raise ValueError(f"spatialvla serving is single-env per connection; adapter produced a "
                             f"{inputs['image'].shape[0]}-row request")
        image = float_to_u8(np.asarray(inputs["image"]))  # [1, H, W, 3] uint8
        s = cfg.vision.image_size
        if image.shape[1] != s or image.shape[2] != s:
            image = np.stack([cv2.resize(im, (s, s), interpolation=cv2.INTER_LINEAR) for im in image])
        depth = obs.get("observation.depth")
        if depth is None:
            # no depth estimator on the serving host: the flat-plane prior
            depth = self.wrapper.model.flat_depth(image.shape[0], cfg)
        else:
            g = cfg.vision.grid
            d = np.asarray(depth, np.float32)
            if d.ndim == 2:
                d = d[None]
            depth = np.stack([cv2.resize(di, (g, g), interpolation=cv2.INTER_AREA) for di in d])
        return {"image": image, "depth": np.asarray(depth, np.float32), "task": inputs["task"]}

    def reset(self) -> None:
        super().reset()
        self.ensembler.reset()


def _init_native_serving(mod, cfg, config, policy, device, materialize: bool = True):
    """The parameter tree of a native AR wrapper on one card -> (params,
    quantize). Random weights from config.seed, made on the device in the
    param dtype; with eval_cfg.quantize_int8 they are quantized leaf by leaf
    (`cm.quantize_params(consume=True)`), so the fp tree and the int8 tree
    never coexist whole. materialize=False makes the tree on the meta device
    (shapes only), for a wrapper about to load a checkpoint."""
    from intact_tpu_torch.models import common as cm

    quantize = bool(getattr(config.eval_cfg, "quantize_int8", False))
    params = mod.init(cfg, config.seed, device if materialize else "meta", policy.param_dtype)
    if quantize:
        params = cm.quantize_params(params, consume=True)
    return params, quantize


def _put_native_checkpoint(raw, policy, quantize: bool, device):
    """A host parameter tree (an importer's or a restored step's) -> the
    serving tree on the device: int8 through `cm.quantize_host_tree` (the fp
    tree never lands on the device whole), else the param dtype."""
    from intact_tpu_torch.models import common as cm

    if quantize:
        return cm.quantize_host_tree(raw, policy, device)
    return cm.tree_map(lambda x: torch.as_tensor(x).to(device=device, dtype=policy.param_dtype), raw)


def _native_switch_model(wrapper, mod, load_fn, new_model_path) -> None:
    """switch_model of the native AR wrappers: an HF snapshot directory (with
    `*.safetensors`) goes to the family's importer `load_fn`, anything else
    to the port's step_{n} parameter checkpoints. A `*.safetensors` file
    raises: the importer reads the snapshot directory (index and shards)."""
    import os

    from intact_tpu_torch.train import checkpoint as ckpt_lib

    if str(new_model_path).endswith(".safetensors"):
        raise ValueError(f"{new_model_path} is a safetensors FILE; pass its snapshot directory (the importer "
                         "reads the index and every shard)")
    if os.path.isdir(new_model_path) and any(f.endswith(".safetensors") for f in os.listdir(new_model_path)):
        raw = load_fn(new_model_path, wrapper.model_cfg)
    else:
        raw = ckpt_lib.restore_params(new_model_path, mod.init(wrapper.model_cfg, device="meta"))
    wrapper.params = _put_native_checkpoint(raw, wrapper.policy, wrapper.quantize, wrapper.device)
    wrapper.model_generation += 1


class SpatialVLANativePolicyWrapper(BasePolicyWrapper):
    """Native SpatialVLA serving (models/spatialvla): SigLIP + Ego3D + Gemma2
    spatial-token decode on one card, in bf16 (use_bf16) or with the W8A8
    kernel (eval_cfg.quantize_int8: every block product, the projector and
    the tied unembedding). Each session ensembles the decoded chunk into one
    env action per inference (reference simpler.py:492-519)."""

    session_cls = SpatialVLASession

    def __init__(self, config, device=None):
        """device: CUDA unless given (raises without a CUDA device)."""
        super().__init__(config)
        from intact_tpu_torch.models import common as cm
        from intact_tpu_torch.models.spatialvla import model as svla
        from intact_tpu_torch.models.tokenizer import make_tokenizer

        self.model = svla
        self.model_cfg = cfg = config.make_model_config()
        self.device = cm.resolve_device(device)
        self.policy = cm.SERVING_POLICY if config.use_bf16 else cm.DEFAULT_POLICY
        path = config.eval_cfg.pretrained_model_path
        self.params, self.quantize = _init_native_serving(svla, cfg, config, self.policy, self.device,
                                                          materialize=not path)
        # the PaliGemma2 tokenizer (spatial tokens appended at the tail), or the hash fallback
        self.tokenizer = make_tokenizer(config.resolve_tokenizer_path(), cfg.tokenizer_max_length,
                                        vocab_size=cfg.spatial_offset)
        self.action_tokenizer = svla.make_action_tokenizer(cfg)
        if path:
            self.switch_model(path)
            self.logger.info("loaded checkpoint %s", path)

    def switch_model(self, new_model_path: str) -> None:
        _native_switch_model(self, self.model, self.model.load_spatialvla_checkpoint, new_model_path)
        self.reset()

    def warmup_inputs(self) -> dict:
        s = self.model_cfg.vision.image_size
        return {"image": np.zeros((1, s, s, 3), np.uint8), "depth": self.model.flat_depth(1, self.model_cfg),
                "task": ["warmup"]}

    def _put(self, x: np.ndarray):
        return torch.from_numpy(np.array(x)).to(self.device)  # np.array: a writable copy

    def predict_tokens(self, images_u8: np.ndarray, depth: np.ndarray, tasks: list[str]) -> np.ndarray:
        """One device call: uint8 frames [B, s, s, 3], depth [B, g, g] and B
        task strings -> spatial token ids [B, 3 * n_action_steps]."""
        cfg = self.model_cfg
        lang_tokens, lang_masks = self.tokenizer(tasks, cfg.tokenizer_max_length)
        ids = self.model.predict_action_tokens(
            self.params, self.model.normalize_images(self._put(images_u8)), self._put(depth), self._put(lang_tokens),
            self._put(lang_masks), cfg, self.policy)
        return ids.cpu().numpy()

    def _infer_fused(self, items):
        """Fuse N single-row requests into one decode (the last row repeated up
        to the bucket), then decode each item's tokens, ensemble them in its
        session and postprocess."""
        cfg = self.model_cfg
        arrays, tasks = self._fuse_pad(items, ("image", "depth"))
        ids = self.predict_tokens(arrays["image"], arrays["depth"], tasks)
        out = []
        for i, (_, session) in enumerate(items):
            try:
                chunk = self.action_tokenizer.decode(ids[i].reshape(cfg.n_action_steps, cfg.tokens_per_action))
                out.append(session.adapter.postprocess(session.ensembler.ensemble(chunk)[None]))
            except Exception as e:  # noqa: BLE001 — isolated per request
                out.append(e)
        return out


class MagmaSession(PolicySession):
    """Magma's host-side image prep: the adapter's frame as uint8, resized to
    the ConvNeXt resolution; the CLIP normalization runs on the card."""

    wants_uint8 = True

    def preprocess(self, obs: dict) -> dict:
        import cv2

        from intact_tpu_torch.utils.device import float_to_u8

        inputs = self.adapter.preprocess(obs)
        if inputs["image"].shape[0] != 1:
            raise ValueError(f"magma serving is single-env per connection; adapter produced a "
                             f"{inputs['image'].shape[0]}-row request")
        s = self.wrapper.model_cfg.image_size
        u8 = float_to_u8(np.asarray(inputs["image"]))
        if u8.shape[1] != s or u8.shape[2] != s:
            u8 = np.stack([cv2.resize(im, (s, s), interpolation=cv2.INTER_LINEAR) for im in u8])
        return {"image": u8, "task": inputs["task"]}


class MagmaNativePolicyWrapper(BasePolicyWrapper):
    """Native Magma serving (models/magma): ConvNeXt + projector + LLaMA-3
    action-token decode on one card, in bf16 (use_bf16) or with the W8A8
    kernel (eval_cfg.quantize_int8: every LLaMA block product and the untied
    lm_head; the vision tower and projector stay fp). Each inference gives
    one env action per row: the first n_action_tokens tokens through the
    vocabulary-tail bins, denormalized with the action quantiles, then the
    adapter's postprocess (reference policy_wrapper.py:1074-1104)."""

    session_cls = MagmaSession

    def __init__(self, config, device=None):
        """device: CUDA unless given (raises without a CUDA device)."""
        super().__init__(config)
        from intact_tpu_torch.models import common as cm
        from intact_tpu_torch.models.magma import model as magma
        from intact_tpu_torch.models.tokenizer import make_tokenizer

        self.model = magma
        self.model_cfg = cfg = config.make_model_config()
        self.device = cm.resolve_device(device)
        self.policy = cm.SERVING_POLICY if config.use_bf16 else cm.DEFAULT_POLICY
        path = config.eval_cfg.pretrained_model_path
        self.params, self.quantize = _init_native_serving(magma, cfg, config, self.policy, self.device,
                                                          materialize=not path)
        # the LLaMA-3 tokenizer, or the hash fallback with its ids kept below
        # image_token_id: a text id equal to the placeholder would take a
        # vision embedding
        self.tokenizer = make_tokenizer(config.resolve_tokenizer_path(), cfg.max_prompt_tokens,
                                        vocab_size=min(cfg.image_token_id, cfg.lm.vocab_size))
        if path:
            self.switch_model(path)
            self.logger.info("loaded checkpoint %s", path)

    def switch_model(self, new_model_path: str) -> None:
        _native_switch_model(self, self.model, self.model.load_magma_checkpoint, new_model_path)
        self.env_adapter.reset()

    def warmup_inputs(self) -> dict:
        s = self.model_cfg.image_size
        return {"image": np.zeros((1, s, s, 3), np.uint8), "task": ["warmup"]}

    def _put(self, x: np.ndarray):
        return torch.from_numpy(np.array(x)).to(self.device)  # np.array: a writable copy

    def generate_tokens(self, images_u8: np.ndarray, tasks: list[str]) -> np.ndarray:
        """One device call: uint8 frames [B, s, s, 3] and B task strings ->
        greedy ids [B, n_action_tokens + 1]."""
        tokens, masks = self.model.build_prompt(self.tokenizer, tasks, self.model_cfg)
        ids = self.model.generate(self.params, self.model.normalize_images(self._put(images_u8)), self._put(tokens),
                                  self._put(masks), self.model_cfg, self.policy)
        return ids.cpu().numpy()

    def _infer_fused(self, items):
        """Fuse N single-row requests into one decode (the last row repeated up
        to the bucket), then turn each item's tokens into its env action."""
        from intact_tpu_torch.serve.decoding import denormalize_with_quantiles, tokens_to_actions

        cfg = self.model_cfg
        arrays, tasks = self._fuse_pad(items, ("image",))
        ids = self.generate_tokens(arrays["image"], tasks)
        mask = np.array([True] * 6 + [False])  # the gripper is not denormalized
        out = []
        for i, (_, session) in enumerate(items):
            try:
                norm = tokens_to_actions(ids[i, :cfg.n_action_tokens], vocab_size=cfg.lm.vocab_size,
                                         n_bins=cfg.n_action_bins)
                stats = session.adapter.dataset_statistics["action"]
                raw = denormalize_with_quantiles(norm, stats["p01"], stats["p99"], mask)
                out.append(session.adapter.postprocess(raw[None]))
            except Exception as e:  # noqa: BLE001 — isolated per request
                out.append(e)
        return out


class OctoSession(PolicySession):
    """Octo's per-connection state: the image-history deque (maxlen =
    history) and its timestep pad mask (reference policy_wrapper.py:344-354).
    A co-batched client's reset leaves every other episode's history alone.
    Frames ship as uint8; the wrapper normalizes them on the card."""

    wants_uint8 = True

    def __init__(self, wrapper, adapter):
        super().__init__(wrapper, adapter)
        from collections import deque

        self.history = deque(maxlen=wrapper.model_cfg.history)

    def preprocess(self, obs: dict) -> dict:
        from intact_tpu_torch.utils.device import float_to_u8

        cfg = self.wrapper.model_cfg
        inputs = self.adapter.preprocess(obs)
        if inputs["image"].shape[0] != 1:
            # the history is one episode's deque: an N-env request folded into it would serve envs 1..N-1 wrong
            raise ValueError(f"octo serving is single-env per connection; adapter produced a "
                             f"{inputs['image'].shape[0]}-row request")
        got = tuple(inputs["image"].shape[1:3])
        if got != (cfg.image_size, cfg.image_size):
            # the adapter owns the resize Octo was evaluated with; resizing again here would corrupt it
            raise ValueError(f"octo adapter produced {got} images but the model expects ({cfg.image_size}, "
                             f"{cfg.image_size}); set env.image_size accordingly")
        self.history.append(float_to_u8(np.asarray(inputs["image"][0])))
        frames = list(self.history)
        n_pad = cfg.history - len(frames)
        return {
            "images": np.stack([frames[0]] * n_pad + frames)[None],  # [1, T, H, W, 3], front-padded
            "img_masks": np.array([[False] * n_pad + [True] * len(frames)]),
            "state": np.asarray(inputs["state"], np.float32),
            "task": inputs["task"],
        }

    def reset(self) -> None:
        super().reset()
        self.history.clear()


class OctoPolicyWrapper(BasePolicyWrapper):
    """Serves Octo on one card: the native model (octo, octo_tiny; the port's
    step_{n} checkpoints) and the released architecture with T5-base
    (octo_*_upstream; released flax-msgpack snapshots through
    `load_octo_checkpoint`), with the reference's semantics (policy_wrapper.py:
    305-371): the per-connection history deque, the text task, diffusion
    sampling from a torch.Generator seeded from config.seed. Parameters are
    fp32 and compute bf16 (DEFAULT_POLICY) whatever use_bf16 says, as in the
    reference; the reference has no int8 Octo, so quantize_int8 raises."""

    session_cls = OctoSession

    def __init__(self, config, device=None):
        """device: CUDA unless given (raises without a CUDA device)."""
        super().__init__(config)
        from intact_tpu_torch.models import common as cm
        from intact_tpu_torch.models import registry
        from intact_tpu_torch.models.tokenizer import make_tokenizer

        if getattr(config.eval_cfg, "quantize_int8", False):
            raise NotImplementedError("octo has no int8 serving path (the reference quantizes no Octo model); "
                                      "set eval_cfg.quantize_int8 false")
        self.model_cfg = cfg = config.make_model_config()
        self.model = registry.module(config.model_type)
        self._upstream = "upstream" in config.model_type
        self.device = cm.resolve_device(device)
        self.policy = cm.DEFAULT_POLICY
        path = config.eval_cfg.pretrained_model_path
        self.params = self.model.init(cfg, config.seed, "meta" if path else self.device, torch.float32)
        vocab = cfg.t5.vocab_size if self._upstream else cfg.vocab_size
        # the released model conditions on the t5-base tokenizer; without the asset, the hash tokenizer
        tok_path = config.resolve_tokenizer_path() or ("t5-base" if self._upstream else None)
        try:
            self.tokenizer = make_tokenizer(tok_path, cfg.max_lang_tokens, vocab_size=vocab)
        except RuntimeError:
            if tok_path != "t5-base":
                raise  # an asset that was asked for and failed stays loud
            self.logger.warning("t5-base tokenizer asset unavailable; falling back to the hermetic hash tokenizer "
                                "(NOT t5-vocab-compatible)")
            self.tokenizer = make_tokenizer("hash", cfg.max_lang_tokens, vocab_size=vocab)
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        if path:
            self.switch_model(path)
            self.logger.info("loaded checkpoint %s", path)

    def switch_model(self, new_model_path: str) -> None:
        """Released Octo snapshots (flax msgpack) through the upstream
        converter for the octo_*_upstream types; the port's step_{n}
        checkpoints for the native ones."""
        from intact_tpu_torch.models import common as cm
        from intact_tpu_torch.train import checkpoint as ckpt_lib

        if self._upstream:
            raw = self.model.load_octo_checkpoint(new_model_path, self.model_cfg)
        else:
            raw = ckpt_lib.restore_params(new_model_path, self.model.init(self.model_cfg, device="meta"))
        self.params = cm.tree_map(lambda x: x.to(device=self.device, dtype=torch.float32), raw)
        self.reset()
        self.model_generation += 1

    def warmup_inputs(self) -> dict:
        cfg = self.model_cfg
        s = cfg.image_size
        return {
            "images": np.zeros((1, cfg.history, s, s, 3), np.uint8),
            "img_masks": np.ones((1, cfg.history), bool),
            # the native model's proprio width; the released one takes no state (the adapter sends 7 zeros)
            "state": np.zeros((1, getattr(cfg, "proprio_dim", 7)), np.float32),
            "task": ["warmup"],
        }

    def _put(self, x: np.ndarray):
        return torch.from_numpy(np.array(x)).to(self.device)  # np.array: a writable copy

    def sample_chunk(self, images_u8: np.ndarray, img_masks: np.ndarray, tasks: list[str],
                     state: np.ndarray) -> np.ndarray:
        """One device call: uint8 frames [B, T, s, s, 3], their masks [B, T],
        B task strings and states [B, d] -> the raw action chunks [B,
        horizon, action_dim] (fp32). Frames normalize on the card as x * (2 /
        255) - 1, as the reference's jitted sample does, before the model."""
        cfg = self.model_cfg
        lang_tokens, lang_masks = self.tokenizer(tasks, cfg.max_lang_tokens)
        images = self._put(images_u8).to(torch.float32) * (2.0 / 255.0) - 1.0
        with torch.inference_mode():
            chunk = self.model.sample_actions(self.params, self.generator, images, self._put(img_masks),
                                              self._put(lang_tokens), self._put(lang_masks), self._put(state), cfg,
                                              self.policy)
        return chunk.cpu().numpy()

    def _infer_fused(self, items):
        """Fuse N single-row requests (each with its session's history
        already stacked) into one bucketed diffusion sample, then each item's
        first action_step actions through its adapter's postprocess."""
        arrays, tasks = self._fuse_pad(items, ("images", "img_masks", "state"))
        chunk = self.sample_chunk(arrays["images"], arrays["img_masks"], tasks, arrays["state"])
        out = []
        for i, (_, session) in enumerate(items):
            try:
                out.append(session.adapter.postprocess(chunk[i, :self.action_step]))
            except Exception as e:  # noqa: BLE001 — isolated per request
                out.append(e)
        return out


def make_policy_wrapper(config, device=None):
    """Model type -> its wrapper from the registry; device: CUDA unless
    given. An unported type (the HF-scaffold spatialvla and magma) raises
    there: the ROADMAP item on the HF-scaffold wrappers."""
    from intact_tpu_torch.models import registry

    wrapper = get_class_from_path(registry.get(config.model_cfg.get("type", "pi0"))["wrapper"])
    return wrapper(config, device=device)
