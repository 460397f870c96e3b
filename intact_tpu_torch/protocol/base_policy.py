"""Abstract policy interface served over the wire.

Mirrors the reference contract (`policy_server_client/base_policy.py:4-13`)
plus the optional hot-swap hook used by the checkpoint-sweep protocol
(`websocket_policy_server.py:66-71`).
"""

from __future__ import annotations

import abc


class BasePolicy(abc.ABC):
    @abc.abstractmethod
    def infer(self, obs: dict) -> dict:
        """Map one observation dict to an action payload."""

    @abc.abstractmethod
    def reset(self) -> None:
        """Reset episode state (action queues, adapters, RNG)."""

    def switch_model(self, new_model_path: str) -> None:
        """Hot-swap the underlying checkpoint. Optional; servers call this
        when a client sends a `new_model_path` message."""
        raise NotImplementedError(f"{type(self).__name__} does not support switch_model")
