"""Policy wrappers: glue between the wire protocol, env adapters and the model.

The Pi0 part of intact_tpu/serve/policy_wrapper.py: `select_action(obs) ->
np.ndarray [action_step, dim]`, `reset()`, `switch_model(path)` (hot
checkpoint swap for checkpoint sweeps), and ONE fused-batch contract,
`infer_batch(items)`, that both the per-request path (`select_action`) and
the continuous-batching server route through.

Per-connection episode state (the env adapter's episode state) lives in a
`PolicySession`, created per websocket connection by the batching server via
`new_session()`; the shared policy on the card stays stateless across
co-batched clients. The wrapper serves one card (CUDA unless the caller
passes device="cpu"); serving over several cards and the families other than
Pi0 and Pi0FAST are ROADMAP items ("serving and training over several
cards", "the other model families and their wrappers").
"""

from __future__ import annotations

import numpy as np

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
    """Serves Pi0 and Pi0FAST checkpoints of the port (bf16, or int8 with
    eval_cfg.quantize_int8) on one card; the model module comes from the
    registry by model type."""

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


def make_policy_wrapper(config, device=None):
    """Model type -> its wrapper from the registry; device: CUDA unless
    given. An unported type (octo, spatialvla, magma, mvla) raises there:
    the ROADMAP item "the other model families and their wrappers"."""
    from intact_tpu_torch.models import registry

    wrapper = get_class_from_path(registry.get(config.model_cfg.get("type", "pi0"))["wrapper"])
    return wrapper(config, device=device)
