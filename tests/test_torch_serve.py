"""The PyTorch port's Pi0 serving on the CPU: Pi0Policy behind the port's
WebsocketPolicyServer on loopback, driven by the port's client."""

import asyncio
import threading

import numpy as np
import pytest

from intact_tpu_torch.models.pi0.config import Pi0Config
from intact_tpu_torch.models.pi0.policy import Pi0Policy
from intact_tpu_torch.protocol import msgpack_numpy
from intact_tpu_torch.protocol.websocket_policy_client import WebsocketPolicyClient
from intact_tpu_torch.protocol.websocket_policy_server import WebsocketPolicyServer


def make_obs(cfg, b=1, seed=0):
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    return {
        "image": rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8),
        "state": rng.standard_normal((b, 7), dtype=np.float32),
        "task": ["put the spoon on the towel"] * b,
    }


class CountingPolicy(Pi0Policy):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.inferences = 0
        self.resets = 0

    def sample_action_chunk(self, batch):
        self.inferences += 1
        return super().sample_action_chunk(batch)

    def reset(self):
        self.resets += 1
        super().reset()


@pytest.fixture
def server_client():
    cfg = Pi0Config.tiny()
    policy = CountingPolicy(cfg, seed=0, tokenizer_path="hash", use_bf16=False, device="cpu")
    server = WebsocketPolicyServer(policy, host="127.0.0.1", port=0, metadata={"model": "pi0_tiny"})
    loop = asyncio.new_event_loop()
    port_holder, stop_holder = {}, {}
    started = threading.Event()

    async def _run():
        import websockets.asyncio.server

        stop_holder["stop"] = asyncio.Event()
        async with websockets.asyncio.server.serve(
            server._handler, "127.0.0.1", 0, compression=None, max_size=None
        ) as ws_server:
            port_holder["port"] = ws_server.sockets[0].getsockname()[1]
            started.set()
            await stop_holder["stop"].wait()

    def _thread():
        try:
            loop.run_until_complete(_run())
        except Exception:
            pass
        finally:
            loop.close()

    t = threading.Thread(target=_thread, daemon=True)
    t.start()
    assert started.wait(10)
    client = WebsocketPolicyClient("127.0.0.1", port_holder["port"], retry_interval_s=0.1)
    yield cfg, policy, client
    try:
        client._ws.close_socket()  # abortive close: the server sees a dead peer at once
    except Exception:
        pass
    try:
        loop.call_soon_threadsafe(stop_holder["stop"].set)
    except RuntimeError:
        pass
    t.join(timeout=10)
    assert not t.is_alive()


class TestPi0Serving:
    def test_metadata_infer_reset(self, server_client):
        cfg, policy, client = server_client
        assert client.get_server_metadata() == {"model": "pi0_tiny"}
        obs = make_obs(cfg)
        actions = [client.infer(obs) for _ in range(cfg.n_action_steps + 1)]
        for a in actions:
            assert a.shape == (1, cfg.max_action_dim) and a.dtype == np.float32
            assert np.isfinite(a).all()
        assert policy.inferences == 2  # the queue drains after n_action_steps
        assert client.reset() == {"status": "reset"}
        assert policy.resets == 1
        client.infer(obs)
        assert policy.inferences == 3  # a reset empties the queue

    def test_actions_match_direct_call(self, server_client):
        cfg, _, client = server_client
        obs = make_obs(cfg, seed=3)
        direct = Pi0Policy(cfg, seed=0, tokenizer_path="hash", use_bf16=False, device="cpu")
        np.testing.assert_array_equal(client.infer(obs), direct.select_action(obs))

    def test_server_error_ships_traceback_and_survives(self, server_client):
        cfg, _, client = server_client
        with pytest.raises(RuntimeError, match="KeyError"):
            client.infer({"state": np.zeros((1, 7), np.float32), "task": ["x"]})  # no "image"
        fresh = WebsocketPolicyClient(client.host, client.port, retry_interval_s=0.1)
        try:
            assert fresh.infer(make_obs(cfg)).shape == (1, cfg.max_action_dim)
        finally:
            fresh._ws.close_socket()


class TestWire:
    def test_ndarray_layout_is_the_reference_one(self):
        import msgpack

        arr = np.arange(6, dtype=np.float32).reshape(2, 3)
        raw = msgpack.unpackb(msgpack_numpy.packb(arr))
        assert raw[b"__ndarray__"] is True and raw[b"dtype"] == "<f4"
        assert raw[b"shape"] == [2, 3] and raw[b"data"] == arr.tobytes()
        np.testing.assert_array_equal(msgpack_numpy.unpackb(msgpack_numpy.packb(arr)), arr)

    def test_rejects_object_dtype(self):
        with pytest.raises(ValueError, match="Unsupported dtype"):
            msgpack_numpy.packb(np.array([object()]))

    def test_same_bytes_as_the_jax_package(self):
        from intact_tpu.protocol import msgpack_numpy as jmsg

        obs = {"image": np.zeros((2, 4, 4, 3), np.uint8), "state": np.float32(1.5), "task": "a"}
        assert msgpack_numpy.packb(obs) == jmsg.packb(obs)
