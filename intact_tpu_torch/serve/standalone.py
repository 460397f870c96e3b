"""Serve a bare Pi0 policy over the websocket protocol, without a config file.

    python -m intact_tpu_torch.serve --port 8000 [--tiny] [--device cpu] [--seed 0]

Builds `Pi0Policy` (random weights from `--seed`; bridge config unless
`--tiny`) on the CUDA device unless `--device` names
another, and serves it with `WebsocketPolicyServer` until interrupted. The
configured server role (env adapter, batching, checkpoints) runs through
`python -m intact_tpu_torch.run --config_path <yaml> --eval_cfg.role server`.
"""

from __future__ import annotations

import argparse
import logging

from intact_tpu_torch.models.pi0.config import Pi0Config
from intact_tpu_torch.models.pi0.policy import Pi0Policy
from intact_tpu_torch.protocol.websocket_policy_server import WebsocketPolicyServer


def build_server(cfg: Pi0Config, host: str = "0.0.0.0", port: int = 8000, device=None,
                 seed: int = 0, tokenizer_path: str = "hash"):
    policy = Pi0Policy(cfg, seed=seed, tokenizer_path=tokenizer_path, device=device)
    metadata = {"model": "pi0", "device": str(policy.device), "chunk_size": cfg.chunk_size}
    return WebsocketPolicyServer(policy, host=host, port=port, metadata=metadata)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--tiny", action="store_true", help="Pi0Config.tiny() instead of the bridge config")
    ap.add_argument("--device", default=None, help="torch device (default: cuda; raises without one)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tokenizer_path", default="hash")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = Pi0Config.tiny() if args.tiny else Pi0Config.bridge()
    server = build_server(cfg, args.host, args.port, args.device, args.seed, args.tokenizer_path)
    server.serve_forever()

