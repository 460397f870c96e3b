"""Synchronous websocket client used by simulator evaluators.

Blocks, retrying every `retry_interval_s`, until the server binds; a `str`
response frame is a server traceback and raises; `switch_model` drives
checkpoint-sweep hot swaps.
"""

from __future__ import annotations

import logging
import time

from intact_tpu_torch.protocol import msgpack_numpy
from intact_tpu_torch.protocol.base_policy import BasePolicy


class WebsocketPolicyClient(BasePolicy):
    def __init__(self, host: str, port: int, retry_interval_s: float = 5.0):
        self.host = host
        self.port = port
        self._retry_interval_s = retry_interval_s
        self.logger = logging.getLogger("websockets.client")
        self._uri = f"ws://{host}:{port}"
        self._ws, self._server_metadata = self._wait_for_server()
        self._packer = msgpack_numpy.Packer()

    def get_server_metadata(self) -> dict:
        return self._server_metadata

    def _wait_for_server(self):
        import websockets.sync.client

        self.logger.info("Waiting for server at %s...", self._uri)
        while True:
            try:
                conn = websockets.sync.client.connect(
                    self._uri, compression=None, max_size=None, ping_timeout=None
                )
                metadata = msgpack_numpy.unpackb(conn.recv())
                return conn, metadata
            except ConnectionRefusedError:
                self.logger.info("Still waiting for server...")
                time.sleep(self._retry_interval_s)

    def _roundtrip(self, payload: dict):
        self._ws.send(self._packer.pack(payload))
        response = self._ws.recv()
        if isinstance(response, str):
            # Text frames carry server tracebacks (binary frames carry data).
            raise RuntimeError(f"Error in inference server:\n{response}")
        return msgpack_numpy.unpackb(response)

    def infer(self, obs: dict) -> dict:
        return self._roundtrip(obs)

    def reset(self) -> None:
        return self._roundtrip({"reset": True})

    def switch_model(self, new_model_path) -> None:
        return self._roundtrip({"new_model_path": new_model_path})

    def close(self) -> None:
        self._ws.close()
