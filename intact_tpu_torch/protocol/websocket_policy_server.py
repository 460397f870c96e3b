"""Websocket policy server — reference-protocol compatible.

Protocol:
  * on connect the server pushes a msgpack metadata dict;
  * each client frame is a msgpack obs dict. Control messages:
      {"new_model_path": str}  -> policy.switch_model(path), ack {"status": ...}
      {"reset": True}          -> policy.reset(),            ack {"status": ...}
    anything else             -> policy.select_action(obs) -> packed action;
  * on an inference exception the server sends the traceback as a *text*
    frame (clients detect `str` responses as errors) then closes with
    INTERNAL_ERROR.

One request at a time per connection. `websockets` is imported by the
methods that serve, so importing this module needs only msgpack.
"""

from __future__ import annotations

import asyncio
import logging
import traceback

from intact_tpu_torch.protocol import msgpack_numpy


class WebsocketPolicyServer:
    def __init__(
        self,
        policy,
        host: str = "0.0.0.0",
        port: int = 8000,
        metadata: dict | None = None,
    ) -> None:
        self._policy = policy
        self._host = host
        self._port = port
        self._metadata = metadata or {}
        self.logger = logging.getLogger("policy_server")
        self.logger.setLevel(logging.INFO)

    def serve_forever(self) -> None:
        asyncio.run(self.run())

    async def run(self):
        import websockets.asyncio.server

        async with websockets.asyncio.server.serve(
            self._handler,
            self._host,
            self._port,
            compression=None,
            max_size=None,
        ) as server:
            self.logger.info("Serving on %s:%s", self._host, self._port)
            await server.serve_forever()

    async def _handler(self, websocket) -> None:
        import websockets
        import websockets.frames

        self.logger.info("Connection from %s opened", websocket.remote_address)
        packer = msgpack_numpy.Packer()

        await websocket.send(packer.pack(self._metadata))

        while True:
            try:
                obs = msgpack_numpy.unpackb(await websocket.recv())

                new_model_path = obs.get("new_model_path") if isinstance(obs, dict) else None
                if new_model_path is not None:
                    self._policy.switch_model(new_model_path)
                    self.logger.info("Switched model to %s", new_model_path)
                    await websocket.send(packer.pack({"status": "model switched"}))
                    continue

                if isinstance(obs, dict) and obs.get("reset", False):
                    self._policy.reset()
                    await websocket.send(packer.pack({"status": "reset"}))
                    continue

                action = self._policy.select_action(obs)
                await websocket.send(packer.pack(action))
            except websockets.ConnectionClosed:
                self.logger.info("Connection from %s closed", websocket.remote_address)
                break
            except Exception:
                # Ship the traceback as a text frame so the sync client can
                # surface the server-side error, then crash loudly.
                await websocket.send(traceback.format_exc())
                await websocket.close(
                    code=websockets.frames.CloseCode.INTERNAL_ERROR,
                    reason="Internal server error. Traceback included in previous frame.",
                )
                raise
