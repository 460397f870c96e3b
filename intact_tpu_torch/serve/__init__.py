"""Serving: the policy wrappers (fuse contract, sessions), the continuous-batching
server and the server entry. `build_server` serves a bare Pi0Policy
(`python -m intact_tpu_torch.serve`)."""

from intact_tpu_torch.serve.standalone import build_server, main

__all__ = ["build_server", "main"]
