"""Policy wrappers: glue between the wire protocol, env adapters and the model.

The wrappers of intact_tpu/serve/policy_wrapper.py (Pi0, native SpatialVLA,
native Magma, Octo and the HF-scaffold SpatialVLA and Magma):
`select_action(obs) -> np.ndarray [action_step, dim]`, `reset()`, `switch_model(path)` (hot
checkpoint swap for checkpoint sweeps), and ONE fused-batch contract,
`infer_batch(items)`, that both the per-request path (`select_action`) and
the continuous-batching server route through.

Per-connection episode state (the env adapter's episode state) lives in a
`PolicySession`, created per websocket connection by the batching server via
`new_session()`; the shared policy on the card stays stateless across
co-batched clients. A wrapper serves on CUDA unless the caller passes
device="cpu".

Over several ranks (`mesh` with a process group; run.py's server role under
torchrun) the Pi0-shaped, native SpatialVLA and native Magma wrappers hold
this rank's shard of the parameters (parallel/sharding.py's rules at
fsdp > 1) and run their device calls through serve/group.py: rank 0 serves
and pads each fused batch to a multiple of the world (`effective_fused_size`),
every rank runs its rows, and `switch_model` restores each rank's share. Octo
and the HF-scaffold wrappers (`serves_on_ranks` False) run whole on rank 0,
as the JAX package serves Octo on one device. At mesh.tensor > 1 Pi0, MVLA,
Pi0FAST, native SpatialVLA and native Magma serve (each rank its tensor slice
of the split leaves, by the model module's `tensor_heads`; the tensor ranks of
one batch coordinate on the same rows); the other families refuse it.
"""

from __future__ import annotations

import os

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
    # the ranks' mesh and serving group (serve/group.py), None on one card
    mesh = None
    group = None
    serves_on_ranks = True  # False: the family runs whole on rank 0 (run.py)

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

    def effective_fused_size(self, n: int) -> int:
        """The device batch a fuse of n rows runs at: the bucket, rounded up
        to a multiple of data x fsdp over a mesh."""
        target = self.bucket_size(n)
        if self.mesh is not None:
            target += -target % (self.mesh.data * self.mesh.fsdp)
        return target

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
        over the items, its last row repeated up to effective_fused_size, and
        the task list padded to match -> (arrays by key, tasks)."""
        n = len(items)
        pad = self.effective_fused_size(n) - n
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
        """Run one dummy inference per distinct device batch (buckets that
        round to the same effective_fused_size run once), so the first
        clients meet no first-call costs (kernel builds, allocator growth)."""
        session = self.new_session()
        inputs = self.warmup_inputs()
        seen: set[int] = set()
        for b in self.bucket_sizes():
            eff = self.effective_fused_size(b)
            if eff in seen:
                continue
            seen.add(eff)
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
        """Hot checkpoint swap; over a group rank 0 sends the path and every
        rank restores its own share."""
        if self.group is None:
            self._switch(new_model_path)
            return
        from intact_tpu_torch.serve.group import path_array

        if not os.path.exists(new_model_path):  # before the ranks see it: a follower's failure ends the group
            raise FileNotFoundError(f"no checkpoint at {new_model_path}")
        self.group.call("switch", [path_array(new_model_path)])

    def _switch(self, new_model_path: str) -> None:
        raise NotImplementedError

    def _join(self, mesh, op: str, rows_fn) -> None:
        """Serve over the ranks of `mesh` when it has a process group: the
        wrapper's serving group, whose `op` runs `rows_fn` on a rank's rows
        and whose "switch" runs `_switch`. Without a group, nothing."""
        if mesh is None or not mesh.distributed:
            return
        from intact_tpu_torch.models import registry
        from intact_tpu_torch.parallel.mesh import MeshConfig, refuse_tensor
        from intact_tpu_torch.serve.group import ServeGroup, path_of

        refuse_tensor(MeshConfig(mesh.data, mesh.fsdp, mesh.tensor), registry.family(self.config.model_type),
                      serving=True)
        self.mesh = mesh
        self.group = ServeGroup(mesh, self.device)
        self.group.on(op, rows_fn)
        self.group.on("switch", lambda path: self._switch(path_of(path)), rows=False)

    def _on_ranks(self, op: str, rows_fn, arrays, extra=None) -> torch.Tensor:
        """`rows_fn` over host arrays: here, or over the group (rank 0: the
        batch padded to the world by repeating its last row, `extra(rows)`'s
        arrays for the padded batch appended, each rank on its rows, the
        gathered output without the padding)."""
        from intact_tpu_torch.serve.group import to_device

        if self.group is None:
            return rows_fn(*(to_device(x, self.device) for x in arrays))
        from intact_tpu_torch.parallel.sharding import pad_rows

        n = arrays[0].shape[0]
        arrays = pad_rows(list(arrays), self.group.rows)
        if extra is not None:
            arrays += extra(arrays[0].shape[0])
        return self.group.call(op, arrays)[:n]

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
    (bf16, or int8 with eval_cfg.quantize_int8) on one card, or over the
    ranks of a mesh; the model module comes from the registry by model type."""

    session_cls = Pi0Session

    def __init__(self, config, device=None, mesh=None):
        """device: CUDA unless given (raises without a CUDA device). mesh:
        the ranks' mesh (parallel.make_mesh); with a process group every rank
        builds the wrapper and rank 0 serves (run.py)."""
        super().__init__(config)
        from intact_tpu_torch.models import registry
        from intact_tpu_torch.models.pi0.policy import Pi0Policy

        self.model_cfg = config.make_model_config()
        self.policy = Pi0Policy(
            self.model_cfg, seed=config.seed, use_bf16=config.use_bf16,
            tokenizer_path=config.resolve_tokenizer_path(), device=device,
            quantize=config.eval_cfg.quantize_int8, model_module=registry.module(config.model_type), mesh=mesh,
        )
        self.device = self.policy.device
        self._join(mesh, "sample", self.policy._sample_rows)
        path = config.eval_cfg.pretrained_model_path
        if path:
            self.policy.load(path)
            self.logger.info("loaded checkpoint %s", path)

    def reset(self) -> None:
        super().reset()
        self.policy.reset()

    def _switch(self, new_model_path: str) -> None:
        self.policy.load(new_model_path)
        self.env_adapter.reset()
        self.model_generation += 1

    def sample_action_chunk(self, batch: dict) -> np.ndarray:
        """One device call (Pi0Policy.sample_action_chunk's batch) -> [B,
        chunk_size, max_action_dim] float32; over a group each rank samples
        its rows of the padded batch, on the noise rank 0 draws for all of
        it (none for a greedy model), so a world of N gives one card's
        actions on the same padded batch, as the JAX package's single key does."""
        policy = self.policy
        if self.group is None:
            return policy.sample_action_chunk(batch)
        noise = None if getattr(policy.model, "GREEDY", False) else lambda rows: [policy._draw_noise(rows)]
        return self._on_ranks("sample", policy._sample_rows, policy.prepare_inputs(batch), noise).cpu().numpy()

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
            parts.append(self.sample_action_chunk({"image": ci, "state": cs, "task": ct})[:m])
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
        from intact_tpu_torch.utils.device import float_to_u8

        cfg = self.wrapper.model_cfg
        inputs = self.adapter.preprocess(obs)
        if inputs["image"].shape[0] != 1:
            # the ensembler is one episode's state: a vectorized request has no meaning through it
            raise ValueError(f"spatialvla serving is single-env per connection; adapter produced a "
                             f"{inputs['image'].shape[0]}-row request")
        image = float_to_u8(np.asarray(inputs["image"]))  # [1, H, W, 3] uint8
        s = cfg.vision.image_size
        if image.shape[1] != s or image.shape[2] != s:  # cv2 only where a frame is resized
            import cv2

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
            if d.shape[1:] != (g, g):
                import cv2

                d = np.stack([cv2.resize(di, (g, g), interpolation=cv2.INTER_AREA) for di in d])
            depth = d
        return {"image": image, "depth": np.asarray(depth, np.float32), "task": inputs["task"]}

    def reset(self) -> None:
        super().reset()
        self.ensembler.reset()


def _native_shards(mod, cfg, mesh) -> tuple[bool, dict | None]:
    """(whether a rank keeps a share of the tree: over fsdp or tensor ranks,
    the family's heads map at tensor > 1, as `shard_tree` takes it)."""
    sharded = mesh is not None and (mesh.fsdp > 1 or mesh.tensor > 1)
    return sharded, mod.tensor_heads(cfg) if sharded and mesh.tensor > 1 else None


def _init_native_serving(mod, cfg, config, policy, device, mesh=None, materialize: bool = True):
    """The parameter tree of a native AR wrapper on its card -> (params,
    quantize). Random weights from config.seed, made on the device in the
    param dtype; with eval_cfg.quantize_int8 they are quantized leaf by leaf
    (`cm.quantize_params(consume=True)`), so the fp tree and the int8 tree
    never coexist whole. Over fsdp or tensor ranks (`mesh`) each rank then
    keeps its share (`shard_tree(consume=True)`, the family's heads map
    at tensor > 1). materialize=False makes the whole tree on the meta
    device (shapes only), for a wrapper about to load a checkpoint."""
    from intact_tpu_torch.models import common as cm

    quantize = bool(getattr(config.eval_cfg, "quantize_int8", False))
    params = mod.init(cfg, config.seed, device if materialize else "meta", policy.param_dtype)
    if quantize:
        params = cm.quantize_params(params, consume=True)
    sharded, heads = _native_shards(mod, cfg, mesh)
    if materialize and sharded:
        from intact_tpu_torch.parallel.sharding import shard_tree

        params = shard_tree(params, mesh, consume=True, heads=heads)
    return params, quantize


def _put_native_checkpoint(raw, mod, cfg, policy, quantize: bool, device, mesh=None):
    """A host parameter tree (an importer's or a restored step's) of `mod`'s
    model -> the serving tree on the device, leaf by leaf: int8 through
    `cm.quantize_host_tree` (the fp tree never lands on the device whole),
    else the param dtype; over fsdp or tensor ranks (`mesh`) each rank keeps
    its share of every leaf the rules split (a checkpoint holds the
    one-rank layout)."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.parallel.sharding import shard_leaf, shard_tree

    sharded, heads = _native_shards(mod, cfg, mesh)
    if quantize:
        place = (lambda path, x: shard_leaf(path, x, mesh, heads=heads)) if sharded else None  # noqa: E731
        return cm.quantize_host_tree(raw, policy, device, place=place)

    def put(x):
        return torch.as_tensor(x).to(device=device, dtype=policy.param_dtype)

    return shard_tree(raw, mesh, put=put, heads=heads) if sharded else cm.tree_map(put, raw)


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
    wrapper.params = _put_native_checkpoint(raw, mod, wrapper.model_cfg, wrapper.policy, wrapper.quantize,
                                            wrapper.device, wrapper.mesh)
    wrapper.model_generation += 1


class SpatialVLANativePolicyWrapper(BasePolicyWrapper):
    """Native SpatialVLA serving (models/spatialvla): SigLIP + Ego3D + Gemma2
    spatial-token decode on one card or over the ranks of a mesh, in bf16
    (use_bf16) or with the W8A8 kernel (eval_cfg.quantize_int8: every block
    product, the projector and the tied unembedding). Each session ensembles
    the decoded chunk into one env action per inference (reference
    simpler.py:492-519)."""

    session_cls = SpatialVLASession

    def __init__(self, config, device=None, mesh=None):
        """device: CUDA unless given (raises without a CUDA device). mesh:
        the ranks' mesh (parallel.make_mesh), as for Pi0PolicyWrapper."""
        super().__init__(config)
        from intact_tpu_torch.models import common as cm
        from intact_tpu_torch.models.spatialvla import model as svla
        from intact_tpu_torch.models.tokenizer import make_tokenizer

        self.model = svla
        self.model_cfg = cfg = config.make_model_config()
        self.device = cm.resolve_device(device)
        self.policy = cm.SERVING_POLICY if config.use_bf16 else cm.DEFAULT_POLICY
        self._join(mesh, "predict", self._predict_rows)
        path = config.eval_cfg.pretrained_model_path
        self.params, self.quantize = _init_native_serving(svla, cfg, config, self.policy, self.device, self.mesh,
                                                          materialize=not path)
        # the PaliGemma2 tokenizer (spatial tokens appended at the tail), or the hash fallback
        self.tokenizer = make_tokenizer(config.resolve_tokenizer_path(), cfg.tokenizer_max_length,
                                        vocab_size=cfg.spatial_offset)
        self.action_tokenizer = svla.make_action_tokenizer(cfg)
        if path:  # every rank restores its own share
            self._switch(path)
            self.logger.info("loaded checkpoint %s", path)

    def _switch(self, new_model_path: str) -> None:
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
        task strings -> spatial token ids [B, 3 * n_action_steps]; over a
        group the batch is padded to the world and each rank decodes its rows."""
        lang_tokens, lang_masks = self.tokenizer(tasks, self.model_cfg.tokenizer_max_length)
        return self._on_ranks("predict", self._predict_rows, [images_u8, depth, lang_tokens, lang_masks]).cpu().numpy()

    def _predict_rows(self, images_u8, depth, lang_tokens, lang_masks) -> torch.Tensor:
        return self.model.predict_action_tokens(self.params, self.model.normalize_images(images_u8), depth,
                                                lang_tokens, lang_masks, self.model_cfg, self.policy)

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
        from intact_tpu_torch.utils.device import float_to_u8

        inputs = self.adapter.preprocess(obs)
        if inputs["image"].shape[0] != 1:
            raise ValueError(f"magma serving is single-env per connection; adapter produced a "
                             f"{inputs['image'].shape[0]}-row request")
        s = self.wrapper.model_cfg.image_size
        u8 = float_to_u8(np.asarray(inputs["image"]))
        if u8.shape[1] != s or u8.shape[2] != s:  # cv2 only where a frame is resized
            import cv2

            u8 = np.stack([cv2.resize(im, (s, s), interpolation=cv2.INTER_LINEAR) for im in u8])
        return {"image": u8, "task": inputs["task"]}


class MagmaNativePolicyWrapper(BasePolicyWrapper):
    """Native Magma serving (models/magma): ConvNeXt + projector + LLaMA-3
    action-token decode on one card or over the ranks of a mesh, in bf16 (use_bf16) or with the W8A8
    kernel (eval_cfg.quantize_int8: every LLaMA block product and the untied
    lm_head; the vision tower and projector stay fp). Each inference gives
    one env action per row: the first n_action_tokens tokens through the
    vocabulary-tail bins, denormalized with the action quantiles, then the
    adapter's postprocess (reference policy_wrapper.py:1074-1104)."""

    session_cls = MagmaSession

    def __init__(self, config, device=None, mesh=None):
        """device: CUDA unless given (raises without a CUDA device). mesh:
        the ranks' mesh (parallel.make_mesh), as for Pi0PolicyWrapper."""
        super().__init__(config)
        from intact_tpu_torch.models import common as cm
        from intact_tpu_torch.models.magma import model as magma
        from intact_tpu_torch.models.tokenizer import make_tokenizer

        self.model = magma
        self.model_cfg = cfg = config.make_model_config()
        self.device = cm.resolve_device(device)
        self.policy = cm.SERVING_POLICY if config.use_bf16 else cm.DEFAULT_POLICY
        self._join(mesh, "generate", self._generate_rows)
        path = config.eval_cfg.pretrained_model_path
        self.params, self.quantize = _init_native_serving(magma, cfg, config, self.policy, self.device, self.mesh,
                                                          materialize=not path)
        # the LLaMA-3 tokenizer, or the hash fallback with its ids kept below
        # image_token_id: a text id equal to the placeholder would take a
        # vision embedding
        self.tokenizer = make_tokenizer(config.resolve_tokenizer_path(), cfg.max_prompt_tokens,
                                        vocab_size=min(cfg.image_token_id, cfg.lm.vocab_size))
        if path:  # every rank restores its own share
            self._switch(path)
            self.logger.info("loaded checkpoint %s", path)

    def _switch(self, new_model_path: str) -> None:
        _native_switch_model(self, self.model, self.model.load_magma_checkpoint, new_model_path)
        self.env_adapter.reset()

    def warmup_inputs(self) -> dict:
        s = self.model_cfg.image_size
        return {"image": np.zeros((1, s, s, 3), np.uint8), "task": ["warmup"]}

    def _put(self, x: np.ndarray):
        return torch.from_numpy(np.array(x)).to(self.device)  # np.array: a writable copy

    def generate_tokens(self, images_u8: np.ndarray, tasks: list[str]) -> np.ndarray:
        """One device call: uint8 frames [B, s, s, 3] and B task strings ->
        greedy ids [B, n_action_tokens + 1]; over a group the batch is padded
        to the world and each rank decodes its rows."""
        tokens, masks = self.model.build_prompt(self.tokenizer, tasks, self.model_cfg)
        return self._on_ranks("generate", self._generate_rows, [images_u8, tokens, masks]).cpu().numpy()

    def _generate_rows(self, images_u8, tokens, masks) -> torch.Tensor:
        return self.model.generate(self.params, self.model.normalize_images(images_u8), tokens, masks,
                                   self.model_cfg, self.policy)

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
    serves_on_ranks = False  # as in the JAX package, Octo is served whole on one device

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

    def _switch(self, new_model_path: str) -> None:
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


class SpatialVLAPolicyWrapper(BasePolicyWrapper):
    """SpatialVLA-4B through the upstream HF model (trust_remote_code; JAX
    package policy_wrapper.py:569-611): the adapter and the transformers
    model, one request at a time. The model is not part of this framework:
    without the asset at eval_cfg.pretrained_model_path (a local snapshot:
    the port reads no hub) it raises."""

    serves_on_ranks = False  # a transformers model on rank 0 alone

    def __init__(self, config, device=None):
        """device: CUDA unless given (raises without a CUDA device)."""
        super().__init__(config)
        from intact_tpu_torch.models import common as cm

        self.device = cm.resolve_device(device)
        path = config.eval_cfg.pretrained_model_path
        try:
            from transformers import AutoModel, AutoProcessor

            self.processor = AutoProcessor.from_pretrained(path, trust_remote_code=True, local_files_only=True)
            self.model = AutoModel.from_pretrained(path, trust_remote_code=True, local_files_only=True).to(self.device)
        except Exception as e:
            raise RuntimeError(f"SpatialVLA serving needs the upstream HF checkpoint (pretrained_model_path={path!r}); "
                               "the native model serves as spatialvla_native") from e
        self.unnorm_key = config.eval_cfg.unnorm_key

    def _switch(self, new_model_path: str) -> None:
        from transformers import AutoModel

        self.model = AutoModel.from_pretrained(new_model_path, trust_remote_code=True,
                                               local_files_only=True).to(self.device)
        self.model_generation += 1

    def _infer_fused(self, items):
        return _each_item(self, items)

    def _infer_one(self, inputs: dict, session: PolicySession) -> np.ndarray:
        from intact_tpu_torch.utils.device import float_to_u8

        # the processor rescales and normalizes uint8 pixels itself; the adapter's frames are float [-1, 1]
        image = float_to_u8(np.asarray(inputs["image"]))[0]
        hf_inputs = self.processor(images=image, text=inputs["task"][0], return_tensors="pt").to(self.device)
        out = self.model.predict_action(hf_inputs)
        actions = self.processor.decode_actions(out, unnorm_key=self.unnorm_key)
        return session.adapter.postprocess(np.asarray(actions)[: self.action_step])


class MagmaPolicyWrapper(BasePolicyWrapper):
    """Magma-8B through the upstream HF model (JAX package
    policy_wrapper.py:614-668): chat-template prompt, generate, the last 7
    action tokens through the 256 vocabulary-tail bins (serve/decoding.py),
    quantile unnormalization. Without the asset it raises."""

    N_ACTION_TOKENS = 7
    serves_on_ranks = False  # a transformers model on rank 0 alone

    def __init__(self, config, device=None):
        """device: CUDA unless given (raises without a CUDA device)."""
        super().__init__(config)
        from intact_tpu_torch.models import common as cm

        self.device = cm.resolve_device(device)
        path = config.eval_cfg.pretrained_model_path
        try:
            from transformers import AutoModelForCausalLM, AutoProcessor

            self.processor = AutoProcessor.from_pretrained(path, trust_remote_code=True, local_files_only=True)
            self.model = AutoModelForCausalLM.from_pretrained(path, trust_remote_code=True,
                                                              local_files_only=True).to(self.device)
        except Exception as e:
            raise RuntimeError(f"Magma serving needs the upstream HF checkpoint (pretrained_model_path={path!r}); "
                               "the native model serves as magma_native") from e

    def _switch(self, new_model_path: str) -> None:
        from transformers import AutoModelForCausalLM

        self.model = AutoModelForCausalLM.from_pretrained(new_model_path, trust_remote_code=True,
                                                          local_files_only=True).to(self.device)
        self.model_generation += 1

    def _infer_fused(self, items):
        return _each_item(self, items)

    def _infer_one(self, inputs: dict, session: PolicySession) -> np.ndarray:
        from intact_tpu_torch.serve.decoding import denormalize_with_quantiles, tokens_to_actions
        from intact_tpu_torch.utils.device import float_to_u8

        convo = [{"role": "user", "content": f"<image>\nWhat action should the robot take to {inputs['task'][0]}?"}]
        prompt = self.processor.tokenizer.apply_chat_template(convo, tokenize=False, add_generation_prompt=True)
        image = float_to_u8(np.asarray(inputs["image"]))[0]  # uint8 for the processor's own normalize
        hf_inputs = self.processor(images=image, texts=prompt, return_tensors="pt").to(self.device)
        output_ids = self.model.generate(**hf_inputs, max_new_tokens=1000, use_cache=False)
        action_ids = output_ids.cpu().numpy()[0, -(self.N_ACTION_TOKENS + 1):-1]
        # the bins count from the end of the model's output vocabulary (its config), not the tokenizer's
        vocab = getattr(self.model.config, "vocab_size", None) or len(self.processor.tokenizer)
        norm = tokens_to_actions(action_ids, vocab_size=vocab)
        stats = session.adapter.dataset_statistics["action"]
        mask = np.array([True] * 6 + [False])
        raw = denormalize_with_quantiles(norm, stats["p01"], stats["p99"], mask)
        return session.adapter.postprocess(raw[None])


def _each_item(wrapper, items) -> list:
    """One inference per request (the HF-scaffold families have no fused
    device path), each failure isolated to its request."""
    out = []
    for inputs, session in items:
        try:
            out.append(wrapper._infer_one(inputs, session))
        except Exception as e:  # noqa: BLE001 — isolated per request
            out.append(e)
    return out


def wrapper_class(config):
    """The wrapper class of the config's model type (from the registry)."""
    from intact_tpu_torch.models import registry

    return get_class_from_path(registry.get(config.model_cfg.get("type", "pi0"))["wrapper"])


def make_policy_wrapper(config, device=None, mesh=None):
    """Model type -> its wrapper from the registry; device: CUDA unless
    given; mesh: the ranks' mesh for the families that serve over ranks
    (`serves_on_ranks`), ignored by the others."""
    wrapper = wrapper_class(config)
    if mesh is not None and wrapper.serves_on_ranks:
        return wrapper(config, device=device, mesh=mesh)
    return wrapper(config, device=device)
