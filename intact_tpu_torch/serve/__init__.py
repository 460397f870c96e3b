"""Serving: the policy wrappers (fuse contract, sessions) and the
continuous-batching websocket server, started by the server role of
`python -m intact_tpu_torch.run`."""
