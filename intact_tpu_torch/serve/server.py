"""Server entry: pick the per-request server (reference semantics) or the
continuous-batching server (the default whenever max_batch_size > 1); a copy
of intact_tpu/serve/server.py."""

from __future__ import annotations

from intact_tpu_torch.protocol.websocket_policy_server import WebsocketPolicyServer


def serve(policy_wrapper, config) -> None:
    """Blocking. policy_wrapper follows the select_action/reset/switch_model
    surface; whenever max_batch_size > 1 it is served through the
    request-fusing server instead, through the wrapper's `infer_batch` fuse
    contract."""
    ec = config.eval_cfg
    metadata = {
        "model": config.model_cfg.get("type", "pi0"),
        "action_step": ec.action_step,
    }
    if ec.max_batch_size > 1:
        from intact_tpu_torch.serve.batching import BatchingPolicyServer

        BatchingPolicyServer(
            policy_wrapper,
            config,
            host=ec.host,
            port=ec.port,
            metadata=metadata,
            max_batch_size=ec.max_batch_size,
            batch_timeout_ms=ec.batch_timeout_ms,
            prewarm=ec.prewarm,
        ).serve_forever()
    else:
        WebsocketPolicyServer(
            policy_wrapper, host=ec.host, port=ec.port, metadata=metadata
        ).serve_forever()
